"""torch.profiler over replays of an older CUDA graph crashes the process.

    python -m tpurast_torch.tools.profiler_graph_crash [--kernel ctypes|ctypes-shared|torch] [--graphs 60]
        [--sessions 20] [--profile-every 4] [--keep-every 10]

A reproducer that uses torch, a ten-line CUDA kernel of its own built with
nvcc and loaded with ctypes, and no code of tpurast_torch. It follows the
pattern of chip_smoke.py's run: --sessions torch.profiler sessions over
eager frames; graphs of a frame (about 50 torch operations, a sort and, with
--kernel ctypes, four launches of the ctypes kernel) captured on a stream
of their own and replayed, one of them kept as the "old" graph; then
--graphs more graphs captured and replayed, every --profile-every-th (0:
none) timed by a profiler session over 3 calls, every --keep-every-th kept
and the others destroyed; last, three profiler sessions over 3 calls
of the old graph, where a call copies 19 floats from pinned memory into the
graph's input, replays the graph and clones its outputs.

On an H100 (libcuda 580.159.03, torch 2.11.0+cu128 and its CUPTI) the last
step ends the process with a segmentation fault inside cudaGraphLaunch: the
native stack, printed by a SIGSEGV handler the script builds with gcc, is
libcuda called back from libcupti inside cuGraphLaunch (PERF.md section 7).
What it takes is a graph destroyed after the old one was captured:
"--kernel torch --sessions 0 --graphs 8 --profile-every 0" crashes, with
"--keep-every 1" (no graph destroyed) it survives. --kernel ctypes-shared
links the kernel library against the shared CUDA runtime; --kernel torch
leaves it out (the frame is torch operations only). A run that survives
prints "survived" and exits 0.
"""

from __future__ import annotations

import argparse
import ctypes
import faulthandler
import pathlib
import shutil
import subprocess
import sys
import tempfile
import time

import torch

KERNEL_SRC = r"""
#include <cuda_runtime.h>
__global__ void scale(float* x, int n, float a) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) x[i] = x[i] * a + 1.0f;
}
extern "C" int launch(float* x, int n, float a, void* stream) {
  scale<<<(n + 255) / 256, 256, 0, (cudaStream_t)stream>>>(x, n, a);
  return (int)cudaGetLastError();
}
"""

# A SIGSEGV handler that prints the faulting thread's native frames, then
# takes the default action (faulthandler, enabled after it, prints the
# Python frames first and hands the signal on).
HANDLER_SRC = r"""
#define _GNU_SOURCE
#include <execinfo.h>
#include <signal.h>
#include <stdio.h>
#include <string.h>
#include <ucontext.h>
#include <unistd.h>
static void handler(int sig, siginfo_t* si, void* ctx) {
  void* frames[96];
  int n = backtrace(frames, 96);
  char buf[160];
  void* pc = (void*)((ucontext_t*)ctx)->uc_mcontext.gregs[REG_RIP];
  int len = snprintf(buf, sizeof buf, "native SIGSEGV: address %p, pc %p\n", si->si_addr, pc);
  if (write(2, buf, len) < 0) {}
  backtrace_symbols_fd(frames, n, 2);
  signal(sig, SIG_DFL);
  raise(sig);
}
int install(void) {
  struct sigaction sa;
  memset(&sa, 0, sizeof sa);
  sa.sa_sigaction = handler;
  sa.sa_flags = SA_SIGINFO;
  return sigaction(SIGSEGV, &sa, 0);
}
"""


def build(tmp: pathlib.Path, kernel: str):
    """The ctypes kernel's launch function (None for --kernel torch), and
    the SIGSEGV handler installed."""
    (tmp / "handler.c").write_text(HANDLER_SRC)
    subprocess.run([shutil.which("gcc") or "cc", "-shared", "-fPIC", "-O1", "-o", str(tmp / "handler.so"),
                    str(tmp / "handler.c")], check=True)
    ctypes.CDLL(str(tmp / "handler.so")).install()
    faulthandler.enable()
    if kernel == "torch":
        return None
    (tmp / "k.cu").write_text(KERNEL_SRC)
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    link = ["-cudart", "shared"] if kernel == "ctypes-shared" else []
    subprocess.run([nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared", "-Xcompiler", "-fPIC", *link,
                    "-o", str(tmp / "k.so"), str(tmp / "k.cu")], check=True)
    lib = ctypes.CDLL(str(tmp / "k.so"))
    lib.launch.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_void_p]
    lib.launch.restype = ctypes.c_int
    return lib.launch


def run(kernel: str, graphs: int, sessions: int, profile_every: int, keep_every: int) -> None:
    from torch.profiler import ProfilerActivity, profile

    dev = torch.device("cuda")
    launch = build(pathlib.Path(tempfile.mkdtemp()), kernel)

    def scaled(y):
        if launch is None:
            return y * 0.5 + 1.0
        y = y.clone()
        if launch(y.data_ptr(), y.numel(), 0.5, torch.cuda.current_stream().cuda_stream) != 0:
            raise RuntimeError("the ctypes kernel did not launch")
        return y

    def frame(x, u):
        y = x + u.sum()
        for i in range(40):
            y = torch.sin(y) * 1.0001 + 0.5
            if i % 10 == 0:
                y = scaled(y)
        v, idx = torch.sort(y.view(-1))
        return {"a": v[:16].clone(), "b": idx.int().sum(dtype=torch.int32), "c": (y * 2).contiguous()}

    class Graph:
        def __init__(self, n):
            self.x = torch.randn(n, device=dev)
            self.u = torch.zeros(19, device=dev)
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                frame(self.x, self.u)
            torch.cuda.current_stream().wait_stream(side)
            torch.cuda.synchronize()
            self.graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(self.graph, stream=torch.cuda.Stream()):
                self.out = frame(self.x, self.u)

        def __call__(self, host):
            d = torch.empty(19, device=dev)
            d.copy_(host, non_blocking=True)
            self.u.copy_(d, non_blocking=True)
            self.graph.replay()
            return {k: v.clone() for k, v in self.out.items()}

    host = torch.empty(19, pin_memory=True)

    def device_ms(fn, n):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        return sum(e.self_device_time_total for e in prof.key_averages()) / 1e3 / n

    t0 = time.perf_counter()
    for _ in range(sessions):
        with profile(activities=[ProfilerActivity.CUDA]):
            frame(torch.randn(1 << 18, device=dev), torch.zeros(19, device=dev))
            torch.cuda.synchronize()
    keep = [Graph(1 << 20)]
    device_ms(lambda: keep[0](host), 3)
    old = Graph(909 * 1024)
    for _ in range(6):
        old(host)
    for i in range(graphs):
        g = Graph(1 << 19)
        for _ in range(3):
            g(host)
        if profile_every and i % profile_every == 0:
            device_ms(lambda: g(host), 3)
        if i % keep_every == 0:
            keep.append(g)
        else:
            g.graph.reset()
        del g
    torch.cuda.synchronize()
    print(f"kernel {kernel}: {sessions} sessions, {graphs} graphs in {time.perf_counter() - t0:.1f} s; profiling "
          "the old graph", flush=True)
    for k in range(3):
        print(f"round {k}: {device_ms(lambda: old(host), 3):.4f} device ms a call", flush=True)
    print(f"survived, kernel {kernel} [{torch.cuda.get_device_name(0)}]", flush=True)


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--kernel", choices=("ctypes", "ctypes-shared", "torch"), default="ctypes")
    ap.add_argument("--graphs", type=int, default=60)
    ap.add_argument("--sessions", type=int, default=20)
    ap.add_argument("--profile-every", type=int, default=4)
    ap.add_argument("--keep-every", type=int, default=10)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profiler_graph_crash: no CUDA device", file=sys.stderr)
        return 2
    run(args.kernel, args.graphs, args.sessions, args.profile_every, args.keep_every)
    return 0


if __name__ == "__main__":
    sys.exit(main())
