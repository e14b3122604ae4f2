"""Probe: one CUDA graph whose capture spans several cards.

    python3 scripts/torch_multicard_graph_probe.py            # every variant
    python3 scripts/torch_multicard_graph_probe.py VARIANT    # one variant

Prints the torch and CUDA versions, the cards, peer access between them
and the allocator's pool entry points, then per variant (``thread-2``,
``thread-4``: the other cards' allocations routed to a private pool by
thread; ``all-2``: by any stream; ``none-2``: not routed) captures one
graph from a side stream of card 0 that copies a tensor's chunks to each
card, computes there and copies back, replays it three times with new
inputs and eager allocations on the other cards around each replay, and
prints whether the outputs and those allocations are exact, the replay's
and the eager run's times (CUDA events, 20 runs each) and the pool bytes.
Each variant runs in its own process.  Needs two CUDA cards or more.
"""
import json
import subprocess
import sys
import time
import traceback
from contextlib import ExitStack

import torch


def info():
    n = torch.cuda.device_count()
    peer = [[torch.cuda.can_device_access_peer(i, j) if i != j else None
             for j in range(n)] for i in range(n)]
    apis = {k: hasattr(torch._C, k) for k in (
        "_cuda_beginAllocateToPool", "_cuda_beginAllocateCurrentThreadToPool",
        "_cuda_beginAllocateCurrentStreamToPool", "_cuda_endAllocateToPool",
        "_cuda_releasePool", "_graph_pool_handle")}
    apis["MemPool"] = hasattr(torch.cuda, "MemPool")
    apis["use_mem_pool"] = hasattr(torch.cuda, "use_mem_pool")
    print(json.dumps({"python": sys.version.split()[0],
                      "torch": torch.__version__, "cuda": torch.version.cuda,
                      "cards": n, "names": [torch.cuda.get_device_name(i)
                                            for i in range(n)],
                      "peer": peer, "apis": apis}), flush=True)


def capture(fn, devs, route):
    d0 = devs[0]
    g = torch.cuda.CUDAGraph()
    cur = {d: torch.cuda.current_stream(d) for d in devs}
    streams = {d: torch.cuda.Stream(d) for d in devs}
    for d in devs:
        streams[d].wait_stream(cur[d])
    pools = {}
    torch.cuda.empty_cache()
    r0 = {d: torch.cuda.memory_reserved(d) for d in devs}
    with ExitStack() as st:
        for d in devs[1:]:
            st.enter_context(torch.cuda.stream(streams[d]))
        st.enter_context(torch.cuda.stream(streams[d0]))
        g.capture_begin(capture_error_mode="thread_local")
        failed = None
        try:
            fork = torch.cuda.Event()
            fork.record(streams[d0])
            for d in devs[1:]:
                streams[d].wait_event(fork)
                if route == "thread":
                    pid = torch.cuda.graph_pool_handle()
                    torch._C._cuda_beginAllocateCurrentThreadToPool(d.index,
                                                                   pid)
                    pools[d] = pid
                elif route == "all":
                    pid = torch.cuda.graph_pool_handle()
                    torch._C._cuda_beginAllocateToPool(d.index, pid)
                    pools[d] = pid
            cd = torch.cuda.current_device()
            cs = torch.cuda.current_stream()
            out = fn()
            for d in devs[1:]:
                e = torch.cuda.Event()
                e.record(streams[d])
                streams[d0].wait_event(e)
        except BaseException as e:
            failed = e
        finally:
            for d, pid in pools.items():
                torch._C._cuda_endAllocateToPool(d.index, pid)
            try:
                g.capture_end()
            except BaseException as e:
                failed = failed or e
        if failed is not None:
            raise failed
    for d in devs:
        cur[d].wait_stream(streams[d])
    r1 = {d: torch.cuda.memory_reserved(d) for d in devs}
    print(json.dumps({"current_device_in_capture": cd,
                      "current_stream_device": str(cs.device),
                      "pool_bytes": {str(d): r1[d] - r0[d] for d in devs}}),
          flush=True)
    return g, out, pools


def replay(g, devs):
    d0 = devs[0]
    launch = torch.cuda.current_stream(d0)
    for d in devs[1:]:
        launch.wait_stream(torch.cuda.current_stream(d))
    g.replay()
    for d in devs[1:]:
        torch.cuda.current_stream(d).wait_stream(launch)


def sync(devs):
    for d in devs:
        torch.cuda.synchronize(d)


def run(variant):
    route, n = variant.split("-")
    n = int(n)
    devs = [torch.device("cuda", i) for i in range(n)]
    rows = 1 << 20
    x = torch.arange(rows, device=devs[0], dtype=torch.float32)

    def fn():
        parts = x.chunk(n)
        outs = []
        for k, (p, d) in enumerate(zip(parts, devs)):
            y = p.to(d)                       # peer copy 0 -> k
            z = y * (k + 2) + 1               # an allocation on card k
            outs.append(z.to(devs[0]))        # peer copy k -> 0
        return torch.cat(outs) + x

    def expect(val):
        parts = []
        for k, p in enumerate(torch.full_like(x, val).chunk(n)):
            parts.append(p * (k + 2) + 1)
        return torch.cat(parts) + val

    fn()
    sync(devs)
    t0 = time.perf_counter()
    g, out, pools = capture(fn, devs, route)
    sync(devs)
    t1 = time.perf_counter()
    res = []
    for it in range(3):
        x.copy_(torch.full_like(x, it + 5))
        junk = [torch.full((rows,), -7.0, device=d) for d in devs[1:]
                for _ in range(6)]
        replay(g, devs)
        junk2 = [torch.full((rows,), -9.0, device=d) for d in devs[1:]
                 for _ in range(6)]
        sync(devs)
        res.append({"out_ok": bool(torch.equal(out, expect(it + 5))),
                    "junk_ok": all(bool((j == -7.0).all()) for j in junk),
                    "junk2_ok": all(bool((j == -9.0).all()) for j in junk2)})
        del junk, junk2
    # replay timing against eager
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    ev[0].record()
    for _ in range(20):
        replay(g, devs)
    ev[1].record()
    for _ in range(20):
        fn()
    ev[2].record()
    sync(devs)
    print(json.dumps({"variant": variant, "capture_s": t1 - t0,
                      "runs": res,
                      "replay_ms": ev[0].elapsed_time(ev[1]) / 20,
                      "eager_ms": ev[1].elapsed_time(ev[2]) / 20}),
          flush=True)
    del g, out
    for d, pid in pools.items():
        torch._C._cuda_releasePool(d.index, pid)
    torch.cuda.empty_cache()
    print(json.dumps({"after_release_reserved":
                      {str(d): torch.cuda.memory_reserved(d) for d in devs}}),
          flush=True)


def main():
    if len(sys.argv) > 1:
        try:
            run(sys.argv[1])
        except BaseException:
            traceback.print_exc()
            print(json.dumps({"variant": sys.argv[1], "error":
                              traceback.format_exc()[-600:]}), flush=True)
            sys.exit(1)
        return
    info()
    n = torch.cuda.device_count()
    variants = ["thread-2", "all-2", "none-2"]
    if n >= 4:
        variants.insert(1, "thread-4")
    for v in variants:
        p = subprocess.run([sys.executable, __file__, v], capture_output=True,
                           text=True, timeout=240)
        print(f"== {v} rc={p.returncode}", flush=True)
        print(p.stdout[-4000:], flush=True)
        if p.returncode:
            print(p.stderr[-3000:], flush=True)


if __name__ == "__main__":
    main()
