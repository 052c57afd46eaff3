"""A gloo world of CPU processes for the port's multi-rank tests.

``run_world(n, "module:function", args, tmp)`` starts ``n`` fresh Python
processes, one per rank, that join one process group through a
``file://`` store under ``tmp`` (so parallel test workers never share a
port), run ``function(**args)`` and send its result back pickled. Each
child runs PyTorch with one thread and imports no JAX: the case modules it
runs import only numpy, torch and the port. The world is joined with a
timeout, every child is killed on the way out, and a child's traceback is
raised in the test.

Run as a module it is the child: ``python -m tests.torch_port.mesh_world
SPEC RANK``. ``hold_int8_tree`` is the tests' bound between a tree trained
with int8 Adam moments over a mesh and the same steps whole, and
``hold_int8_updates`` theirs between such a tree and the JAX package's.
"""

from __future__ import annotations

import importlib
import os
import pickle
import subprocess
import sys
import time
import traceback
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[2]


def run_world(n: int, target: str, args: dict, tmp, timeout: float = 300):
    """Results of ``target(**args)`` on each of ``n`` ranks, by rank."""
    tmp = Path(tmp)
    tmp.mkdir(parents=True, exist_ok=True)
    spec = tmp / "spec.pkl"
    with open(spec, "wb") as fh:
        pickle.dump({"n": n, "target": target, "args": args,
                     "store": str(tmp / "store")}, fh)
    env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1",
               PYTHONPATH=str(ROOT) + os.pathsep + os.environ.get(
                   "PYTHONPATH", ""))
    logs = [open(tmp / f"log{r}.txt", "wb") for r in range(n)]
    procs = [subprocess.Popen(
        [sys.executable, "-m", "tests.torch_port.mesh_world", str(spec),
         str(r)], cwd=str(ROOT), env=env, stdout=logs[r],
        stderr=subprocess.STDOUT) for r in range(n)]
    deadline = time.monotonic() + timeout
    try:
        # a rank that fails leaves the others waiting in a collective:
        # stop the world at the first failure (or at the deadline)
        while time.monotonic() < deadline:
            codes = [p.poll() for p in procs]
            if all(c is not None for c in codes) or any(codes):
                break
            time.sleep(0.1)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for fh in logs:
            fh.close()
    errors = []
    for r, p in enumerate(procs):
        if p.returncode != 0:
            out = (tmp / f"log{r}.txt").read_text(errors="replace")
            err = tmp / f"err{r}.txt"
            why = err.read_text() if err.exists() else (
                f"exit {p.returncode} (timeout {timeout} s?)")
            errors.append(f"--- rank {r}:\n{why}\n{out[-3000:]}")
    if errors:
        raise AssertionError("world failed:\n" + "\n".join(errors))
    results = []
    for r in range(n):
        with open(tmp / f"out{r}.pkl", "rb") as fh:
            results.append(pickle.load(fh))
    return results


def _flat(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _flat(v)]
    return [tree]


#: int8 moments against the JAX package's: each leaf's update p - p0 by
#: the norm of the difference over the norm of JAX's. The blocks of m run
#: over each package's own layout of a leaf (the bridge transposes the
#: conv kernels), so such a leaf's m rounds in other blocks (measured on
#: ``test_torch_fsdp.py``'s model: the conv kernels' updates 6.1e-2, their
#: moments 1.4e-2; elsewhere at most 2.5e-3 and 3.7e-3)
INT8_UPDATE_REL = 0.1


def hold_int8_updates(got, ref, start):
    """Each leaf's update ``got - start`` within ``INT8_UPDATE_REL`` of
    ``ref - start`` (numpy trees; ``ref`` JAX's, bridged), by the norm."""
    for a, b, p in zip(_flat(got), _flat(ref), _flat(start)):
        b, p = (t.detach().numpy() if hasattr(t, "detach") else np.asarray(t)
                for t in (b, p))
        err = np.linalg.norm(a - b)
        assert err <= INT8_UPDATE_REL * np.linalg.norm(b - p), (
            err / np.linalg.norm(b - p), b.shape)


def hold_int8_tree(got, want, start):
    """A tree trained with int8 first moments over a mesh (``got``, numpy)
    against the same steps whole (``want``, numpy) from ``start``: within
    the float bound (atol 1e-5, rtol 1e-4) but where rounding in the
    gradients' sums moved an int8 code of m -- in each leaf at most one
    element in 1,000 (one in a leaf of fewer), each within the largest
    update of its leaf (a code is 1/127 of its block's max, and one step
    of m moves that element's direction by up to its size)."""
    for a, b, p in zip(_flat(got), _flat(want), _flat(start)):
        p = p.detach().numpy() if hasattr(p, "detach") else np.asarray(p)
        bad = ~np.isclose(a, b, atol=1e-5, rtol=1e-4)
        assert int(bad.sum()) <= max(1, b.size // 1000), (
            int(bad.sum()), b.shape)
        if bad.any():
            assert np.abs(a - b)[bad].max() <= np.abs(b - p).max(), (
                np.abs(a - b)[bad].max(), np.abs(b - p).max())


def _child(spec_path: str, rank: int) -> int:
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    tmp = Path(spec_path).parent
    with open(spec_path, "rb") as fh:
        spec = pickle.load(fh)
    try:
        dist.init_process_group("gloo", init_method="file://" + spec["store"],
                                rank=rank, world_size=spec["n"])
        mod, fn = spec["target"].split(":")
        result = getattr(importlib.import_module(mod), fn)(**spec["args"])
        with open(tmp / f"out{rank}.pkl", "wb") as fh:
            pickle.dump(result, fh)
        dist.barrier()
        dist.destroy_process_group()
        return 0
    except Exception:
        (tmp / f"err{rank}.txt").write_text(traceback.format_exc())
        return 1


if __name__ == "__main__":
    sys.exit(_child(sys.argv[1], int(sys.argv[2])))
