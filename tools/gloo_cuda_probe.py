"""Which torch.distributed operations the gloo backend takes CUDA tensors for.

    python3 tools/gloo_cuda_probe.py

On a machine with a CUDA card: two spawned ranks on cuda:0 join a gloo
group (a file store in a temporary directory) and try all_reduce,
all_gather, all_to_all_single and a send/recv pair on CUDA tensors, each
result checked against the values it must give. Prints one line per
operation, 'takes CUDA tensors' or the error. parallel.context stages
point-to-point messages of CUDA tensors through the host on gloo, and
hands its collectives the card's tensors; this tells that both are right.
"""
from __future__ import annotations

import datetime
import json
import multiprocessing
import os
import sys
import tempfile

OPS = ("all_reduce", "all_gather", "all_to_all_single", "send_recv")


def _rank(rank: int, store: str, out: str) -> None:
    import torch
    import torch.distributed as dist
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                            world_size=2,
                            timeout=datetime.timedelta(seconds=60))
    dev = torch.device("cuda", 0)
    res = {}
    for op in OPS:
        try:
            x = torch.arange(4.0, device=dev) + 10 * rank
            if op == "all_reduce":
                dist.all_reduce(x)
                ok = x.tolist() == [10.0, 12.0, 14.0, 16.0]
            elif op == "all_gather":
                parts = [torch.empty_like(x) for _ in range(2)]
                dist.all_gather(parts, x)
                ok = parts[1 - rank].tolist() == (
                    torch.arange(4.0) + 10 * (1 - rank)).tolist()
            elif op == "all_to_all_single":
                y = torch.empty_like(x)
                dist.all_to_all_single(y, x)
                want = [10.0 * 0 + 2 * rank, 10.0 * 0 + 2 * rank + 1,
                        10.0 + 2 * rank, 10.0 + 2 * rank + 1]
                ok = y.tolist() == want
            else:
                y = torch.empty_like(x)
                if rank == 0:
                    dist.send(x, 1)
                    dist.recv(y, 1)
                else:
                    dist.recv(y, 0)
                    dist.send(x, 0)
                ok = y.tolist() == (torch.arange(4.0)
                                    + 10 * (1 - rank)).tolist()
            torch.cuda.synchronize()
            res[op] = "takes CUDA tensors" if ok else "wrong values"
        except Exception as e:              # the probe's answer
            res[op] = f"{type(e).__name__}: {str(e).splitlines()[0][:160]}"
        with open(out, "w") as f:
            json.dump(res, f)
    dist.destroy_process_group()


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("gloo_cuda_probe: no CUDA device", file=sys.stderr)
        return 2
    tmp = tempfile.mkdtemp(prefix="gloo-probe-")
    ctx = multiprocessing.get_context("spawn")
    outs = [os.path.join(tmp, f"rank{r}.json") for r in range(2)]
    procs = [ctx.Process(target=_rank, args=(r, os.path.join(tmp, "store"),
                                             outs[r])) for r in range(2)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(120)
        if p.is_alive():
            p.kill()
    for r, path in enumerate(outs):
        res = json.load(open(path)) if os.path.exists(path) else {}
        for op in OPS:
            print(f"gloo, rank {r}, {op}: {res.get(op, 'did not finish')}")
        print(f"rank {r} exit code {procs[r].exitcode}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
