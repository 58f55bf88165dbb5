"""Atomic, background, *elastic* checkpointing (DESIGN.md §6) — port of
``repro/dist/checkpoint.py`` with the reference's on-disk layout, so a
checkpoint written by either package loads in the other.

Layout: one directory per checkpoint under the run's ckpt root::

    <root>/ckpt_00000040/arrays.npz   # every state leaf, keyed by its path
    <root>/ckpt_00000040/meta.json    # step counter + caller metadata

Keys are the state's paths joined by ``"/"`` through dicts and lists
(``theta/<leaf>``, ``z/<level>/<leaf>``, ``rho/<level>/<leaf>``,
``masks/<rule>/idx``, ``wire/<boundary>/<leaf>``, ``weights``, ``k``;
a stateless boundary's empty wire tree writes nothing); the port's flat
leaf keys are already the reference's nested paths.  Arrays are saved
with the dtypes the JAX package writes: the port's int64 tensors (mask
indices) as int32, since the JAX package runs without 64-bit types, and
bf16 leaves as their 2-byte words with the header ``'<V2'``, the one a
JAX save of a bf16 leaf carries (numpy's own 2-byte void type would
write ``'|V2'``), whatever the process has imported; a load reads them
back bit for bit.
:func:`restore` and :func:`restore_elastic` cast every array back to
the template's dtype and put it on the template leaf's device.

Writes go to a hidden temp directory first and are published with a
single ``os.replace``: a crash mid-write can never leave a ``ckpt_*``
directory that :func:`latest` would pick up.  ``save(...,
background=True)`` snapshots the tensors to host memory on the caller's
thread (``.detach().cpu()`` and a real copy), then hands the disk work to
a daemon writer thread; :func:`flush` joins all pending writes.

A run that has physically reconfigured saves its state at the shrunk
budget-B shapes with ``meta["reconfigured"] = True`` and the frozen
full-shape masks in the checkpoint's *aux* arrays (``save(..., aux=...)``
/ :func:`load_aux`); the training loop rebuilds the reconfigured engine
from them and restores straight into it.

Elastic restart (paper §4.6): :func:`restore_elastic` restores into a
template whose worker count ``W`` differs from the saved one.  Surviving
workers keep their rows; new workers are seeded from the global
consensus ``z`` with zero duals and momenta (the reference's rules,
computed in numpy as the reference computes them).
"""
from __future__ import annotations

import json
import os
import queue
import shutil
import threading
import traceback
import zipfile
from typing import Any, Optional

import numpy as np
import torch

from ..convert import from_numpy, is_bf16

_PREFIX = "ckpt_"
_AUX = "aux/"


# ---------------------------------------------------------------------------
# state tree <-> path-keyed flat dict (dicts AND lists: "z/0/blocks/w")
# ---------------------------------------------------------------------------


def _flatten(tree: Any, prefix: str = "") -> dict[str, Any]:
    out: dict[str, Any] = {}
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = ((str(i), v) for i, v in enumerate(tree))
    else:
        out[prefix] = tree
        return out
    for k, v in items:
        path = f"{prefix}/{k}" if prefix else str(k)
        out.update(_flatten(v, path))
    return out


def _like_template(template: Any, fn) -> Any:
    """Rebuild ``template``'s structure, leaf at path p -> fn(p, leaf)."""
    def rec(node, prefix):
        if isinstance(node, dict):
            return {k: rec(v, f"{prefix}/{k}" if prefix else str(k))
                    for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            t = [rec(v, f"{prefix}/{i}" if prefix else str(i))
                 for i, v in enumerate(node)]
            return type(node)(t)
        return fn(prefix, node)
    return rec(template, "")


def _host(x: torch.Tensor, copy: bool) -> np.ndarray:
    """A leaf as the numpy array the JAX package would save: int64 as
    int32, bf16 as its 2-byte words (numpy's void type: :func:`_savez`
    writes their header).  ``copy`` guarantees memory of its own
    (``.cpu()`` of a CPU tensor is the tensor itself)."""
    t = x.detach().cpu()
    if copy and t.data_ptr() == x.data_ptr():
        t = t.clone()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.dtype("V2"))
    a = t.numpy()
    return a.astype(np.int32) if a.dtype == np.int64 else a


def _np_dtype(leaf: torch.Tensor) -> np.dtype:
    """The numpy dtype an elastic restore builds a leaf in: f32 for bf16
    (exact for the saved rows; :func:`_as_leaf` rounds the seeds)."""
    if leaf.dtype == torch.bfloat16:
        return np.dtype(np.float32)
    return torch.empty((), dtype=leaf.dtype).numpy().dtype


def _numeric(a: np.ndarray) -> np.ndarray:
    """A saved array numpy can compute on: bf16 words as f32 (exact)."""
    return from_numpy(a).float().numpy() if is_bf16(a) else a


def _as_leaf(a: np.ndarray, leaf: torch.Tensor) -> torch.Tensor:
    """``a`` with the template leaf's dtype, on its device (a bf16 save
    bit for bit)."""
    if not (a.flags.c_contiguous and a.flags.writeable):
        a = a.copy()
    return from_numpy(a).to(device=leaf.device, dtype=leaf.dtype)


# ---------------------------------------------------------------------------
# atomic write path (+ background writer thread)
# ---------------------------------------------------------------------------


# the header numpy gives ml_dtypes' bfloat16, which a JAX save writes
_BF16_DESCR = "<V2"


def _savez(f, arrays: dict[str, np.ndarray]) -> None:
    """``np.savez(f, **arrays)`` member for member, except that bf16
    words (:func:`_host`) carry the header :data:`_BF16_DESCR`."""
    fmt = np.lib.format
    with zipfile.ZipFile(f, mode="w", compression=zipfile.ZIP_STORED,
                         allowZip64=True) as z:
        for k, a in arrays.items():
            a = np.asanyarray(a)
            with z.open(k + ".npy", "w", force_zip64=True) as fid:
                if not is_bf16(a):
                    fmt.write_array(fid, a, allow_pickle=True)
                    continue
                a = np.ascontiguousarray(a)
                head = fmt.header_data_from_array_1_0(a)
                head["descr"] = _BF16_DESCR
                fmt.write_array_header_1_0(fid, head)
                fid.write(a.tobytes())


def _write(ckpt_dir: str, arrays: dict[str, np.ndarray], meta: dict,
           keep: Optional[int]) -> str:
    step = int(meta.get("step", 0))
    final = os.path.join(ckpt_dir, f"{_PREFIX}{step:08d}")
    tmp = os.path.join(ckpt_dir, f".tmp_{step:08d}_{os.getpid()}"
                                 f"_{threading.get_ident()}")
    os.makedirs(tmp, exist_ok=True)
    try:
        with open(os.path.join(tmp, "arrays.npz"), "wb") as f:
            _savez(f, arrays)
            f.flush()
            os.fsync(f.fileno())
        with open(os.path.join(tmp, "meta.json"), "w") as f:
            json.dump(meta, f)
            f.flush()
            os.fsync(f.fileno())
        if os.path.isdir(final):  # re-save of the same step: replace it
            shutil.rmtree(final)
        os.replace(tmp, final)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    if keep is not None and keep > 0:   # keep<=0 would be "delete all"
        for stale in _list(ckpt_dir)[:-keep]:
            shutil.rmtree(os.path.join(ckpt_dir, stale), ignore_errors=True)
    return final


_queue: "queue.Queue[tuple]" = queue.Queue()
_worker_lock = threading.Lock()
_worker: Optional[threading.Thread] = None


def _drain() -> None:
    while True:
        item = _queue.get()
        try:
            _write(*item)
        except Exception:   # never kill the writer; surface and carry on
            traceback.print_exc()
        finally:
            _queue.task_done()


def _ensure_worker() -> None:
    global _worker
    with _worker_lock:
        if _worker is None or not _worker.is_alive():
            _worker = threading.Thread(target=_drain, name="ckpt-writer",
                                       daemon=True)
            _worker.start()


def flush() -> None:
    """Block until every queued background save has been published."""
    _queue.join()


# ---------------------------------------------------------------------------
# public API
# ---------------------------------------------------------------------------


def save(ckpt_dir: str, state: Any, meta: dict, *, keep: Optional[int] = None,
         background: bool = False, aux: Optional[dict] = None
         ) -> Optional[str]:
    """Write one checkpoint of ``state`` (dicts and lists of tensors).

    ``meta`` must carry an integer ``"step"`` (names the directory; higher
    steps are newer).  ``keep=N`` prunes all but the N newest checkpoints
    after a successful publish.  ``background=True`` copies the tensors to
    host memory on the caller's thread and returns at once; the write runs
    on the daemon writer thread (:func:`flush` to join).  ``aux`` is an
    optional flat dict of side-channel arrays stored under a reserved
    prefix, invisible to :func:`restore`/:func:`restore_elastic` and read
    back with :func:`load_aux`.  Returns the published directory, or None
    for background saves.
    """
    os.makedirs(ckpt_dir, exist_ok=True)
    meta = dict(meta)
    arrays = {p: _host(v, background) for p, v in _flatten(state).items()}
    arrays.update({_AUX + k: _host(v, background)
                   for k, v in (aux or {}).items()})
    if background:
        _ensure_worker()
        _queue.put((ckpt_dir, arrays, meta, keep))
        return None
    return _write(ckpt_dir, arrays, meta, keep)


def _list(ckpt_dir: str) -> list[str]:
    if not os.path.isdir(ckpt_dir):
        return []
    out = [d for d in os.listdir(ckpt_dir)
           if d.startswith(_PREFIX)
           and os.path.exists(os.path.join(ckpt_dir, d, "meta.json"))]
    return sorted(out)


def latest(ckpt_dir: str) -> Optional[str]:
    """Path of the newest complete checkpoint under ``ckpt_dir`` (or None)."""
    names = _list(ckpt_dir)
    return os.path.join(ckpt_dir, names[-1]) if names else None


def _load(path: str) -> tuple[dict[str, np.ndarray], dict]:
    with np.load(os.path.join(path, "arrays.npz")) as z:
        arrays = {k: z[k] for k in z.files}
    return arrays, read_meta(path)


def read_meta(path: str) -> dict:
    """The checkpoint's meta dict alone (no array load): lets a resuming
    loop pick the right template shapes (full or reconfigured) before
    restoring."""
    with open(os.path.join(path, "meta.json")) as f:
        return json.load(f)


def load_aux(path: str) -> dict[str, np.ndarray]:
    """Side-channel arrays stored via ``save(..., aux=...)``, with the
    reserved prefix stripped (empty dict when the save carried none).
    Reads the aux arrays alone."""
    with np.load(os.path.join(path, "arrays.npz")) as z:
        return {k[len(_AUX):]: z[k] for k in z.files if k.startswith(_AUX)}


def restore(path: str, template: Any) -> tuple[Any, dict]:
    """Exact restore: every template leaf must match a saved leaf's shape."""
    arrays, meta = _load(path)

    def one(p, leaf):
        if p not in arrays:
            raise KeyError(f"checkpoint {path} has no leaf {p!r}")
        a = arrays[p]
        if tuple(a.shape) != tuple(leaf.shape):
            raise ValueError(f"leaf {p!r}: saved {a.shape} != "
                             f"template {tuple(leaf.shape)}")
        return _as_leaf(a, leaf)
    return _like_template(template, one), meta


def _global_z(arrays: dict[str, np.ndarray]) -> dict[str, np.ndarray]:
    """Param-key -> top-level consensus value (mean over its lead dim)."""
    ks = [int(p.split("/")[1]) for p in arrays if p.startswith("z/")]
    if not ks:
        return {}
    top = f"z/{max(ks)}/"
    return {p[len(top):]: _numeric(a).mean(axis=0)
            for p, a in arrays.items() if p.startswith(top)}


def restore_elastic(path: str, template: Any,
                    num_workers: int) -> tuple[Any, dict]:
    """Restore into a template whose worker count may differ from the save.

    Leading-dim resize rules per state group (DESIGN.md §6, the
    reference's):

    * ``theta`` / ``z``: surviving rows copied; new rows seeded from the
      global consensus ``z`` for the same parameter leaf (warm start),
    * ``mom`` / ``u`` / ``v`` / ``wire``: surviving rows copied; new rows
      zero (fresh duals, momenta and codec error feedback; ``wire`` also
      zero-seeds when the save predates the codec),
    * ``weights``: new rows 1.0 (a joining worker is healthy until a
      policy says otherwise),
    * ``rho``: per-level penalties are worker-count independent; a level
      missing from the save falls back to the deepest saved level,
    * everything else (masks, counters, class weights) must match exactly.
    """
    arrays, meta = _load(path)
    gz = _global_z(arrays)

    def seed_for(p: str, leaf) -> Optional[np.ndarray]:
        group = p.split("/", 1)[0]
        rest = p.split("/", 2 if group in ("z", "v", "rho") else 1)[-1]
        dtype = _np_dtype(leaf)
        if group in ("theta", "z") and rest in gz:
            return np.broadcast_to(gz[rest], tuple(leaf.shape[1:])).astype(
                dtype)
        if group in ("mom", "u", "v", "wire"):
            return np.zeros(tuple(leaf.shape[1:]), dtype)
        if group == "weights":
            return np.ones(tuple(leaf.shape[1:]), np.float32) \
                if leaf.ndim > 1 else np.float32(1.0)
        return None

    def one(p, leaf):
        group = p.split("/", 1)[0]
        a = arrays.get(p)
        if a is not None and tuple(a.shape) == tuple(leaf.shape):
            return _as_leaf(a, leaf)
        fill = seed_for(p, leaf)
        if group == "rho" and a is None:
            # deeper hierarchy than the save: reuse the deepest saved level
            lv = [int(q.split("/")[1]) for q in arrays
                  if q.startswith("rho/")]
            if lv:
                rest = p.split("/", 2)[-1]
                a = arrays.get(f"rho/{max(lv)}/{rest}")
            # (the reference finds this level too, then raises below: its
            # docstring's fallback never returns)
            if a is not None and tuple(a.shape) == tuple(leaf.shape):
                return _as_leaf(a, leaf)
        if fill is None and a is None:
            raise KeyError(f"checkpoint {path} has no leaf {p!r} and no "
                           f"elastic seed rule for group {group!r}")
        if fill is None:
            raise ValueError(f"leaf {p!r}: saved {a.shape} != template "
                             f"{tuple(leaf.shape)} and group {group!r} is "
                             "not elastic")
        n_new = leaf.shape[0] if leaf.ndim else 0
        out = np.empty(tuple(leaf.shape), _np_dtype(leaf))
        out[...] = fill
        if a is not None and tuple(a.shape[1:]) == tuple(leaf.shape[1:]):
            n = min(a.shape[0], n_new)
            out[:n] = _numeric(a[:n])
        return _as_leaf(out, leaf)

    state = _like_template(template, one)
    meta = dict(meta, restored_workers=num_workers)
    return state, meta
