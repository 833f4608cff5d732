"""Step checkpointing and resumable transients.

The reference has no checkpoint/resume: state lives in ``u_n`` in memory and
all outputs are written only after the loop, so a diverged Newton or a
preempted job loses everything (SURVEY.md §5).  Here the transient runs in
chunks of ``chunk`` scan steps with a checkpoint of (solution, extra carry,
step index, config hash) between chunks; ``resume`` restarts from the
latest checkpoint and refuses configs whose hash changed.
"""

from __future__ import annotations

import hashlib
import json
import os
from dataclasses import asdict, is_dataclass
from typing import Any, Callable, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np


def config_hash(cfg: Any) -> str:
    """Stable hash of a (dataclass) config, ignoring non-physics fields."""
    if is_dataclass(cfg):
        d = asdict(cfg)
    else:
        d = dict(cfg)
    blob = json.dumps(d, sort_keys=True, default=str).encode()
    return hashlib.sha256(blob).hexdigest()[:16]


class TransientCheckpointer:
    """Chunked checkpointing around ``run_transient``-style scans.

    Each checkpoint is ``step_<k>.npz`` (the carry's arrays, in order)
    plus ``step_<k>.json`` (step index and config hash), written to
    temporary names and renamed into place, meta last, so a checkpoint is
    visible only once complete.  The carry is a tuple of arrays."""

    def __init__(self, ckpt_dir: str, cfg: Any = None):
        self.dir = os.path.abspath(ckpt_dir)
        os.makedirs(self.dir, exist_ok=True)
        self.hash = config_hash(cfg) if cfg is not None else None

    def _path(self, step_idx: int, ext: str) -> str:
        return os.path.join(self.dir, f"step_{step_idx:09d}.{ext}")

    def save(self, step_idx: int, carry) -> None:
        leaves = [np.asarray(x) for x in carry]
        arrays = self._path(step_idx, "npz")
        with open(arrays + ".tmp", "wb") as f:
            np.savez(f, *leaves)
        os.replace(arrays + ".tmp", arrays)
        meta = self._path(step_idx, "json")
        with open(meta + ".tmp", "w") as f:
            json.dump({"step": step_idx, "config_hash": self.hash or "",
                       "n_arrays": len(leaves)}, f)
        os.replace(meta + ".tmp", meta)

    def latest(self) -> Optional[Tuple[int, Any]]:
        steps = sorted(int(name[5:-5]) for name in os.listdir(self.dir)
                       if name.startswith("step_") and name.endswith(".json"))
        if not steps:
            return None
        with open(self._path(steps[-1], "json")) as f:
            meta = json.load(f)
        if self.hash and meta.get("config_hash") not in ("", self.hash):
            raise ValueError(
                f"checkpoint at {self.dir} was produced by a different "
                f"config (hash {meta.get('config_hash')} != {self.hash})")
        with np.load(self._path(steps[-1], "npz"),
                     allow_pickle=False) as z:
            carry = tuple(z[f"arr_{i}"] for i in range(meta["n_arrays"]))
        return int(meta["step"]), carry

    def close(self):
        pass


def run_transient_checkpointed(
    step: Callable,
    carry0,
    n_steps: int,
    ckpt: TransientCheckpointer,
    chunk: int = 100,
    update_carry: Optional[Callable] = None,
    theta_of_carry: Optional[Callable] = None,
    step_state_init: Optional[Callable] = None,
):
    """Chunked resumable transient: scan ``chunk`` steps, checkpoint,
    repeat.  Returns (final_carry, ys) with ys concatenated over chunks
    (history of completed chunks before a resume is not re-materialized —
    consumers needing full history should re-run post hoc or keep chunk
    outputs).

    ``step_state_init``: opts into the stateful step protocol of
    ``timeloop.make_carried_step`` — called as
    ``step_state_init(carry, start_index) -> state`` once before the
    first chunk (after any checkpoint restore), and the state is threaded
    across chunks in memory.  The state is DERIVED data (a factorization
    of the current Jacobian) and is deliberately NOT persisted: a resume
    rebuilds it, keeping checkpoints identical to the stateless layout.
    """
    from gmpnp.solve.timeloop import run_transient

    start = 0
    carry = carry0
    latest = ckpt.latest()
    if latest is not None:
        start, carry = latest
        carry = tuple(jnp.asarray(x) for x in carry)

    state = None
    if step_state_init is not None and start < n_steps:
        state = step_state_init(carry, start)

    ys_chunks = []
    i = start
    while i < n_steps:
        k = min(chunk, n_steps - i)
        offset = i

        def theta_shifted(c, j, _offset=offset):
            if theta_of_carry is None:
                return None
            return theta_of_carry(c, j + _offset)

        def update_shifted(extra, u, j, _offset=offset):
            if update_carry is None:
                return extra
            return update_carry(extra, u, j + _offset)

        carry, ys = run_transient(
            step, carry, k,
            update_carry=update_shifted,
            theta_of_carry=theta_shifted,
            step_state0=state)
        if state is not None:
            u_c, extra_c, state = carry
            carry = (u_c, extra_c)
        ys_chunks.append(jax.tree.map(np.asarray, ys))
        i += k
        ckpt.save(i, carry)

    if not ys_chunks:
        return carry, None
    ys = jax.tree.map(lambda *xs: np.concatenate(xs, axis=0), *ys_chunks)
    return carry, ys
