"""Which collectives a gloo process group accepts for CUDA tensors.

    python3 tools/gloo_cuda_probe.py

For each collective the training mesh uses (``runtime/collectives.py``),
two gloo ranks on one card (spawned, TCP rendezvous on localhost) try it on
a CUDA tensor and check its result, in a pair of processes of its own (a
refusal may abort the process), all pairs at once.  Prints one JSON object
{collective: "ok" | "wrong result" | the error's first line | the exit
code or signal of a rank that died}.  The port does not rely on the
answer: on gloo it stages CUDA tensors through host memory.
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
import tempfile

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


COLLECTIVES = ("all_reduce", "all_gather_into_tensor", "all_gather",
               "broadcast", "send_recv")


def _rank(rank: int, world: int, port: int, out: str, which: str) -> None:
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=world)
    dev = torch.device("cuda", 0)
    results = {}

    def attempt(name, fn, check):
        if name != which:
            return
        try:
            got = fn()
            torch.cuda.synchronize()
            results[name] = "ok" if check(got) else "wrong result"
        except Exception as e:   # the probe's purpose: record the refusal
            results[name] = f"{type(e).__name__}: {str(e).splitlines()[0]}"

    x = torch.full((4,), float(rank + 1), device=dev)

    def all_reduce():
        t = x.clone()
        dist.all_reduce(t)
        return t

    def all_gather_into_tensor():
        t = torch.empty(8, device=dev)
        dist.all_gather_into_tensor(t, x.clone())
        return t

    def all_gather():
        ts = [torch.empty(4, device=dev) for _ in range(world)]
        dist.all_gather(ts, x.clone())
        return torch.cat(ts)

    def broadcast():
        t = x.clone()
        dist.broadcast(t, src=1)
        return t

    def send_recv():
        t = x.clone()
        if rank == 0:
            dist.send(t, dst=1)
            return torch.full((4,), 1.0, device=dev)
        dist.recv(t, src=0)
        return t

    both = torch.cat([torch.full((4,), 1.0), torch.full((4,), 2.0)]).to(dev)
    attempt("all_reduce", all_reduce, lambda t: bool((t == 3).all()))
    attempt("all_gather_into_tensor", all_gather_into_tensor,
            lambda t: torch.equal(t, both))
    attempt("all_gather", all_gather, lambda t: torch.equal(t, both))
    attempt("broadcast", broadcast, lambda t: bool((t == 2).all()))
    attempt("send_recv", send_recv, lambda t: bool((t == 1).all()))
    with open(f"{out}.{rank}", "w") as f:
        json.dump(results, f)
    dist.destroy_process_group()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def main() -> int:
    if len(sys.argv) == 3:   # one collective's pair: name, result file
        which, out = sys.argv[1:]
        mp.spawn(_rank, args=(2, _free_port(), out, which), nprocs=2,
                 join=True)
        return 0
    if not torch.cuda.is_available():
        print("gloo_cuda_probe: no CUDA device", file=sys.stderr)
        return 1
    results = {}
    with tempfile.TemporaryDirectory(dir=os.path.dirname(
            os.path.abspath(__file__))) as tmp:
        procs = {name: subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), name,
             os.path.join(tmp, f"{name}.json")],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            for name in COLLECTIVES}
        for name, proc in procs.items():
            try:
                _, err = proc.communicate(timeout=120)
            except subprocess.TimeoutExpired:
                proc.kill()
                _, err = proc.communicate()
            paths = [os.path.join(tmp, f"{name}.json.{r}") for r in (0, 1)]
            if all(os.path.exists(p) for p in paths):
                said = []
                for p in paths:
                    with open(p) as f:
                        said.append(json.load(f)[name])
                results[name] = next((x for x in said if x != "ok"), "ok")
            else:
                last = [ln for ln in err.splitlines() if ln.strip()]
                results[name] = (f"a rank died (exit {proc.returncode}): "
                                 + " | ".join(last[-2:])[-300:])
    print(json.dumps({"torch": torch.__version__,
                      "device": torch.cuda.get_device_name(0),
                      "gloo_cuda": results}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
