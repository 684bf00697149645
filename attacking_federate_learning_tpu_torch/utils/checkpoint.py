"""Checkpoint / resume.

The reference is save-only: ``torch.save({'epoch','state_dict','acc'})``
to ``runs/<dataset>/checkpoint.pth.tar`` whenever accuracy exceeds 70 %,
always overwriting, without the momentum velocity (reference
server.py:40-48, main.py:84-89).  This module is the port's copy of the
JAX package's ``utils/checkpoint.py``: it saves the complete server
state (weights, velocity, round) with the accuracy and the config, and
``resume()`` restores it exactly, so a resumed run continues bit for
bit.

The files are the JAX package's: one ``.npz`` with ``weights`` and
``velocity`` as f32 (d,), ``round`` as a 0-d int32, ``accuracy`` as f32
and one ``extra_<name>`` array per carry-state entry, plus a JSON
sidecar.  A checkpoint either package writes, the other resumes.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Optional

import numpy as np
import torch

from attacking_federate_learning_tpu_torch.core.server import ServerState


def _host(a) -> np.ndarray:
    """A host numpy array of a tensor (any device) or an array."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def _place(z, name: str, device) -> torch.Tensor:
    """Array ``name`` of an open ``.npz`` as an f32 tensor on ``device``
    (a copy: the caller may update it in place)."""
    return torch.tensor(np.asarray(z[name], np.float32), device=device)


class Checkpointer:
    """Best-accuracy checkpoint (the reference behavior) plus rotated
    periodic auto-checkpoints (``checkpoint-auto-<round>.npz``), the
    engine's rollback and ``--resume`` targets.

    Every write is atomic: the ``.npz`` and its ``.json`` sidecar land in
    a temporary file in the same directory, are flushed and fsync'd, and
    ``os.replace`` puts them in place, so a kill never leaves a torn
    checkpoint.  Auto-checkpoints rotate (``keep_last``).

    ``extra``: named arrays saved beside the server state; the engine
    puts its carry state there (the straggler ring, ``extra_stale``:
    (delay, m, d), or (delay, S, m, d) in hierarchical rounds), so a
    resumed faulted run continues bit for bit.

    ``auto_dir``: where the auto-checkpoints live.  By default the
    best-checkpoint dir ``runs/<dataset>/`` (the reference's path,
    server.py:42); a journaled run passes its own ``runs/<run_id>/``, so
    two runs over one dataset never adopt each other's resume points.
    When the private dir holds no auto yet, ``latest()`` falls back to
    autos in the shared dir (the JAX package's older layout).

    What a checkpoint does NOT carry: the attackers' readouts
    (``BackdoorAttack.early_outs``, ``MinMax.last_gamma``), which no
    round reads back, so results do not depend on them; the engine's
    ``last_round_faults`` and watchdog rollback count; and anything a
    run derives again from its config (the model's initial weights,
    shards, the threefry fault, cohort, augmentation and noise streams,
    all keyed on the seed and the round, and the metadata pool).  The
    models keep no buffers: BatchNorm runs on batch statistics.
    """

    _AUTO_PREFIX = "checkpoint-auto-"

    def __init__(self, cfg, run_dir: Optional[str] = None,
                 keep_best: bool = True, keep_last: int = 3,
                 auto_dir: Optional[str] = None):
        self.dir = run_dir or os.path.join(cfg.run_dir, cfg.dataset)
        self.auto_dir = auto_dir or self.dir
        os.makedirs(self.dir, exist_ok=True)
        os.makedirs(self.auto_dir, exist_ok=True)
        self.cfg = cfg
        self.keep_best = keep_best
        self.keep_last = max(1, int(keep_last))
        self.best_acc = -1.0

    @property
    def path(self) -> str:
        return os.path.join(self.dir, "checkpoint.npz")

    def _write_atomic(self, path: str, arrays: dict, meta: dict):
        # The temporary names carry the pid: two processes saving into
        # one runs/<dataset>/ never write the same temporary file.
        tmp = f"{path}.{os.getpid()}.tmp"
        with open(tmp, "wb") as f:
            np.savez(f, **arrays)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
        jpath = path.replace(".npz", ".json")
        jtmp = f"{jpath}.{os.getpid()}.tmp"
        with open(jtmp, "w") as f:
            json.dump(meta, f, indent=1, default=str)
        os.replace(jtmp, jpath)

    def save(self, state: ServerState, accuracy: float, tag: str = None,
             extra: Optional[dict] = None):
        if self.keep_best and tag is None and accuracy < self.best_acc:
            # A later, worse state does not overwrite the best checkpoint
            # (the reference always overwrites, server.py:40-48).
            return self.path
        path = (os.path.join(self.auto_dir, f"checkpoint-{tag}.npz")
                if tag else self.path)
        arrays = dict(weights=_host(state.weights).astype(np.float32),
                      velocity=_host(state.velocity).astype(np.float32),
                      round=np.int32(int(state.round)),
                      accuracy=np.float32(accuracy))
        for k, v in (extra or {}).items():
            arrays[f"extra_{k}"] = _host(v)
        self._write_atomic(path, arrays,
                           {"accuracy": float(accuracy),
                            "round": int(state.round),
                            "config": dataclasses.asdict(self.cfg)})
        if self.keep_best and tag is None and accuracy > self.best_acc:
            self.best_acc = accuracy
        return path

    # --- periodic / on-failure auto-checkpoints ---------------------------
    def save_auto(self, state: ServerState, extra: Optional[dict] = None):
        """Rotated auto-checkpoint at the state's round.  Accuracy is
        recorded as -1 (unknown at a round boundary), so keep_best
        seeding never takes an auto save for a best save."""
        path = self.save(state, accuracy=-1.0,
                         tag=f"auto-{int(state.round):08d}", extra=extra)
        self._rotate()
        return path

    def _autos_in(self, d: str) -> list:
        try:
            names = sorted(n for n in os.listdir(d)
                           if n.startswith(self._AUTO_PREFIX)
                           and n.endswith(".npz"))
        except OSError:
            return []
        return [os.path.join(d, n) for n in names]

    def _auto_paths(self) -> list:
        return self._autos_in(self.auto_dir)

    def _legacy_auto_paths(self) -> list:
        """Autos in the shared dir when the private auto dir is another
        one: resume candidates only, never rotated away."""
        if os.path.abspath(self.auto_dir) == os.path.abspath(self.dir):
            return []
        return self._autos_in(self.dir)

    def _rotate(self):
        for p in self._auto_paths()[: -self.keep_last]:
            for victim in (p, p.replace(".npz", ".json")):
                try:
                    os.remove(victim)
                except OSError:
                    pass

    def latest_auto(self) -> Optional[str]:
        autos = self._auto_paths()
        return autos[-1] if autos else None

    def latest(self) -> Optional[str]:
        """Newest checkpoint by saved round: auto saves and the best save
        compete, so ``--resume`` continues from where the run got."""
        candidates = self._auto_paths() or self._legacy_auto_paths()
        if os.path.exists(self.path):
            candidates = candidates + [self.path]
        best, best_round = None, -1
        for p in candidates:
            try:
                with np.load(p) as z:
                    r = int(z["round"])
            except Exception:
                continue
            if r >= best_round:
                best, best_round = p, r
        return best

    def load_best_acc(self) -> float:
        """Accuracy of the best checkpoint, for keep_best seeding after a
        resume from an auto-checkpoint; -1 without one."""
        if not os.path.exists(self.path):
            return -1.0
        try:
            with np.load(self.path) as z:
                return float(z["accuracy"])
        except Exception:
            return -1.0

    def resume(self, path: Optional[str] = None, with_extra: bool = False,
               device="cuda"):
        """The server state of ``path`` (default: :meth:`latest`, else the
        best checkpoint) as a port ServerState on ``device`` (the
        engine's: ``exp.device``), and with ``with_extra`` the carry
        arrays as host numpy, keyed without their ``extra_`` prefix."""
        from attacking_federate_learning_tpu_torch.core.engine import (
            resolve_device
        )

        device = resolve_device(device)
        path = path or self.latest() or self.path
        with np.load(path) as z:
            state = ServerState(weights=_place(z, "weights", device),
                                velocity=_place(z, "velocity", device),
                                round=int(z["round"]))
            extra = {k[len("extra_"):]: z[k] for k in z.files
                     if k.startswith("extra_")}
        return (state, extra) if with_extra else state


# state_dict entries that are buffers, not ``.parameters()``: the
# reference wire format is parameters only (reference user.py:17-28).
_TORCH_BUFFER_SUFFIXES = ("running_mean", "running_var",
                          "num_batches_tracked")


def import_reference_checkpoint(path: str,
                                expected_dim: Optional[int] = None,
                                device="cuda"):
    """Read a reference checkpoint, ``torch.save({'epoch', 'state_dict',
    'acc'})`` (reference server.py:40-48), or a bare state_dict, and
    flatten its parameters in registration order, the reference's
    ``flatten_params`` over ``.parameters()`` (user.py:17-18).

    Returns ``(ServerState on device, accuracy)``.  The velocity is zero:
    the reference never saves it, so a resume from its checkpoint is as
    inexact as resuming the reference itself would be."""
    from attacking_federate_learning_tpu_torch.core.engine import (
        resolve_device
    )

    device = resolve_device(device)
    blob = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(blob, dict) and "state_dict" in blob:
        state_dict, epoch = blob["state_dict"], int(blob.get("epoch", 0))
        acc = float(blob.get("acc", 0.0))
    else:
        state_dict, epoch, acc = blob, 0, 0.0
    flat = torch.cat([v.detach().to("cpu", torch.float32).reshape(-1)
                      for k, v in state_dict.items()
                      if not k.endswith(_TORCH_BUFFER_SUFFIXES)])
    if expected_dim is not None and flat.numel() != expected_dim:
        raise ValueError(
            f"reference checkpoint has {flat.numel()} parameters, "
            f"model expects {expected_dim}")
    flat = flat.to(device)
    return ServerState(weights=flat, velocity=torch.zeros_like(flat),
                       round=epoch), acc
