"""Device operations that torch.profiler records in windows of
torch.linalg.inv calls, the library call that chip_smoke.py times beside
gj_inverse: (L, 10, 10) float32 batches at the AMR channel's fine drains
(L = 147 and 204 by default) and at 4,096 lanes, 20 calls a window, each
window opened and closed with a marker kernel as chip_smoke.device_profile
opens it. Three rounds of windows: on a fresh process; after --windows
windows of other calls (linalg.inv at 2^17 and 200,000 lanes, a matmul),
as the smoke's earlier phases open them; and with most of the card's
memory held by other tensors. Prints each window's count of device
operations and, for the first window of a shape and every window whose
count differs from it, the count of each operation name.

    python3 tools/profiler_window_counts.py [--lanes 147,204,4096]
                                            [--windows 300] [--hold-gib 60]

Needs a CUDA card; exits 2 without one.
"""
from __future__ import annotations

import argparse
import collections
import json
import sys

REPS = 20


def window(torch, fn, sets):
    """The device operations of REPS calls of fn, as chip_smoke's
    device_profile records them (the marker kernels left out)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(1000)
        for i in range(REPS):
            fn(*sets[i % len(sets)])
        torch.cuda._sleep(1000)
        torch.cuda.synchronize()
    return [e.name for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and "spin_kernel" not in e.name]


def operands(torch, g, L, n=10):
    """Six sets of (L, n, n) float32 matrices near I, as chip_smoke's
    gj_operand makes them (lanes first, as torch.linalg.inv takes them)."""
    return [((torch.eye(n, device="cuda", dtype=torch.float64)
              + 0.1 * torch.randn((L, n, n), generator=g, device="cuda",
                                  dtype=torch.float64)).float(),)
            for _ in range(6)]


def report(torch, tag, lanes, sets, windows_each=5):
    out = {}
    for L in lanes:
        first = None
        counts = []
        for w in range(windows_each):
            names = window(torch, torch.linalg.inv, sets[L])
            counts.append(len(names))
            if first is None or len(names) != first:
                print(f"{tag} L={L} window {w + 1}: {len(names)} operations "
                      f"for {REPS} calls; by name " + json.dumps(
                          collections.Counter(names).most_common()))
                first = first if first is not None else len(names)
        print(f"{tag} L={L}: operations per window {counts}")
        out[L] = counts
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--lanes", default="147,204,4096")
    ap.add_argument("--windows", type=int, default=300)
    ap.add_argument("--hold-gib", type=float, default=60.0)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("profiler_window_counts: no CUDA device", file=sys.stderr)
        return 2
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")
    g = torch.Generator(device="cuda").manual_seed(0)
    lanes = [int(x) for x in args.lanes.split(",")]
    sets = {L: operands(torch, g, L) for L in lanes}
    for L in lanes:
        for s in sets[L]:
            torch.linalg.inv(*s)
    torch.cuda.synchronize()
    result = {"fresh": report(torch, "fresh", lanes, sets)}

    big = {L: operands(torch, g, L) for L in (1 << 17, 200_000)}
    a = torch.randn((2048, 2048), generator=g, device="cuda")
    others = [(torch.linalg.inv, big[1 << 17]), (torch.linalg.inv,
                                                  big[200_000]),
              (lambda x: x @ x, [(a,)])]
    for w in range(args.windows):
        fn, s = others[w % len(others)]
        window(torch, fn, s)
    result["after_windows"] = report(torch, f"after {args.windows} windows",
                                     lanes, sets)
    del big
    held = []
    try:
        for _ in range(int(args.hold_gib)):
            held.append(torch.empty(1 << 30, dtype=torch.uint8,
                                    device="cuda"))
    except torch.OutOfMemoryError:
        pass
    print(f"holding {len(held)} GiB of the card")
    result["memory_held"] = report(torch, "memory held", lanes, sets)
    print(json.dumps({"operations_per_window": result}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
