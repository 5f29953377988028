"""Fault-tolerant checkpointing (port of ``repro.checkpoint.manager``, with
its on-disk format and protocol, so each package verifies the other's
checkpoints):

* atomic: write to a unique temp dir, fsync, write a digest commit marker,
  rename -- a preempted or crashed writer never corrupts the latest
  checkpoint and never collides with a concurrent writer's temp dir;
* verified: every leaf carries a CRC32 in the manifest, and the manifest is
  pinned by a sha256 commit marker (``COMMIT``) written last -- bit rot,
  truncation and half-written checkpoints are detected at restore time;
* rotating: the ``keep_n`` newest checkpoints stay; rotation never deletes
  a checkpoint that a :meth:`restore` is reading;
* async: the snapshot to host memory is synchronous, serialization runs on
  a background thread; a second ``save()`` joins the write in flight, and
  an error on the writer thread surfaces at the next ``save()`` /
  ``wait()``;
* self-describing: ``step_%010d/`` holds ``arrays.npz``, ``manifest.json``
  (step, leaf names, dtypes, shapes, CRC32s, user metadata such as the
  loader state) and ``COMMIT``.

Trees are the port's: NamedTuples (``TrainState``, ``AdamState``,
``QState``), dicts in sorted-key order, lists and tuples; leaves are
tensors or numpy arrays, named by their path as the reference names them
(``params/blocks/attn/wq``, ``opt/m1/.../q``).  Int8 payloads and fp32
sidecars round-trip bit for bit.  numpy has no bfloat16 (without
``ml_dtypes``), so a bfloat16 leaf is stored as its bits in ``uint16``
with ``"bfloat16"`` in the manifest, never upcast.

Recovery entry point: :meth:`restore_latest` walks the rotation newest
first, verifies each candidate, and loads the first intact one.
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import threading
import time
import zlib
from typing import Any, Callable, Dict, List, Optional, Set, Tuple

import numpy as np
import torch

Tree = Any
_SEP = "/"

#: manifest schema version: 2 adds per-leaf crc32 + the COMMIT digest marker
MANIFEST_VERSION = 2


class CheckpointCorrupt(RuntimeError):
    """A checkpoint failed verification (missing files, digest mismatch,
    CRC mismatch, unreadable payload).  Carries the offending step/path."""

    def __init__(self, msg: str, step: Optional[int] = None,
                 path: Optional[str] = None):
        super().__init__(msg)
        self.step = step
        self.path = path


def _is_namedtuple(node) -> bool:
    return isinstance(node, tuple) and hasattr(node, "_fields")


def _children(node):
    """(key, child) pairs of an inner node, or None for a leaf."""
    if _is_namedtuple(node):
        return list(zip(node._fields, node))
    if isinstance(node, dict):
        return [(str(k), node[k]) for k in sorted(node)]
    if isinstance(node, (list, tuple)):
        return [(str(i), c) for i, c in enumerate(node)]
    return None


def _flatten(tree: Tree) -> List[Tuple[str, Any]]:
    out: List[Tuple[str, Any]] = []

    def walk(node, path):
        kids = _children(node)
        if kids is None:
            out.append((_SEP.join(path), node))
            return
        for key, child in kids:
            walk(child, path + [key])
    walk(tree, [])
    return out


def _unflatten(target: Tree, leaves: List[Any]) -> Tree:
    """``target``'s structure with ``leaves`` in :func:`_flatten` order."""
    it = iter(leaves)

    def walk(node):
        if _is_namedtuple(node):
            return type(node)(*(walk(c) for c in node))
        if isinstance(node, dict):
            built = {k: walk(node[k]) for k in sorted(node)}
            return {k: built[k] for k in node}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(c) for c in node)
        return next(it)
    return walk(target)


def _np_dtype_name(leaf) -> str:
    if isinstance(leaf, torch.Tensor):
        if leaf.dtype == torch.bfloat16:
            return "bfloat16"
        return str(torch.empty((), dtype=leaf.dtype).numpy().dtype)
    return str(np.asarray(leaf).dtype)


def _to_host(leaf) -> Tuple[np.ndarray, str]:
    """(host array, manifest dtype) of one leaf; bfloat16 keeps its bits."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        arr = t.numpy()
        return arr, str(arr.dtype)
    arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def _crc(arr: np.ndarray) -> int:
    """CRC32 of the leaf payload bytes (C-contiguous view)."""
    return zlib.crc32(np.ascontiguousarray(arr).tobytes()) & 0xFFFFFFFF


def _manifest_digest(manifest: Dict) -> str:
    """sha256 over the canonicalized manifest content: step, leaf table
    (file keys, dtypes, shapes, CRCs) and metadata."""
    body = json.dumps({"step": manifest["step"],
                       "leaves": manifest["leaves"],
                       "metadata": manifest.get("metadata", {})},
                      sort_keys=True).encode()
    return hashlib.sha256(body).hexdigest()


def _fsync_file(path: str) -> None:
    with open(path, "rb") as f:
        os.fsync(f.fileno())


def _fsync_dir(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


class CheckpointManager:
    def __init__(self, directory: str, keep_n: int = 3,
                 async_write: bool = False):
        self.directory = directory
        self.keep_n = keep_n
        self.async_write = async_write
        self._thread: Optional[threading.Thread] = None
        self._write_error: Optional[BaseException] = None
        self._save_lock = threading.Lock()     # serializes writes + rotation
        self._tmp_seq = 0
        self._reading: Set[int] = set()        # steps a restore() is inside
        #: hooks (see train/faults.py): called with (step) after the array
        #: payload is on disk but before the commit marker, and with
        #: (step, final_path) after a completed write and rotation
        self.on_mid_write: Optional[Callable[[int], None]] = None
        self.on_after_write: Optional[Callable[[int, str], None]] = None
        os.makedirs(directory, exist_ok=True)

    # -- write --------------------------------------------------------------

    def save(self, step: int, tree: Tree,
             metadata: Optional[Dict] = None) -> str:
        """Snapshot to host (synchronous) then serialize (async optional).
        Joins any write in flight first and re-raises an error the previous
        background write hit."""
        self.wait()
        host = [(n, *_to_host(x)) for n, x in _flatten(tree)]
        meta = dict(metadata or {})
        if self.async_write:
            self._thread = threading.Thread(
                target=self._write_guarded, args=(step, host, meta),
                daemon=True)
            self._thread.start()
            return self._ckpt_dir(step)
        return self._write(step, host, meta)

    def wait(self) -> None:
        """Join the async write in flight; raise its error, if any."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._write_error is not None:
            err, self._write_error = self._write_error, None
            raise err

    def _write_guarded(self, step: int, host, meta) -> None:
        try:
            self._write(step, host, meta)
        except BaseException as e:              # lint: except-ok
            # daemon thread: park the error for the next save()/wait()
            self._write_error = e

    def _ckpt_dir(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step:010d}")

    def _write(self, step: int, host, meta) -> str:
        with self._save_lock:
            return self._write_locked(step, host, meta)

    def _write_locked(self, step: int, host, meta) -> str:
        final = self._ckpt_dir(step)
        # a unique temp dir per attempt: a crashed writer's leftovers are
        # never half-reused by the next attempt
        self._tmp_seq += 1
        tmp = f"{final}.tmp-{os.getpid()}-{self._tmp_seq}"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        manifest = {"version": MANIFEST_VERSION, "step": step,
                    "time": time.time(), "metadata": meta, "leaves": {}}
        arrays = {}
        for name, arr, dtype in host:
            key = name.replace(_SEP, "__")
            arrays[key] = arr
            manifest["leaves"][name] = {
                "file_key": key, "dtype": dtype,
                "shape": list(arr.shape), "crc32": _crc(arr)}
        apath = os.path.join(tmp, "arrays.npz")
        np.savez(apath, **arrays)
        _fsync_file(apath)
        if self.on_mid_write is not None:
            # payload on disk, manifest and commit marker not yet: the
            # checkpoint must not be restorable from this state
            self.on_mid_write(step)
        mpath = os.path.join(tmp, "manifest.json")
        with open(mpath, "w") as f:
            json.dump(manifest, f, indent=1)
            f.flush()
            os.fsync(f.fileno())
        # commit marker written last: its presence certifies every earlier
        # byte; its content pins the manifest (and through the CRCs, the
        # payload)
        cpath = os.path.join(tmp, "COMMIT")
        with open(cpath, "w") as f:
            f.write(_manifest_digest(manifest))
            f.flush()
            os.fsync(f.fileno())
        _fsync_dir(tmp)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
        _fsync_dir(self.directory)
        self._rotate_locked()
        if self.on_after_write is not None:
            self.on_after_write(step, final)
        return final

    def _rotate_locked(self) -> None:
        steps = self.all_steps()
        for s in steps[:-self.keep_n] if self.keep_n else []:
            if s in self._reading:
                # a restore() holds this step open; a later save's rotation
                # collects it
                continue
            shutil.rmtree(self._ckpt_dir(s), ignore_errors=True)

    def prune_incomplete(self) -> List[str]:
        """Remove leftover ``*.tmp-*`` dirs of crashed writers."""
        removed = []
        for name in sorted(os.listdir(self.directory)):
            if ".tmp" in name and name.startswith("step_"):
                p = os.path.join(self.directory, name)
                shutil.rmtree(p, ignore_errors=True)
                removed.append(p)
        return removed

    # -- read ---------------------------------------------------------------

    def all_steps(self) -> List[int]:
        out = []
        for name in os.listdir(self.directory):
            if name.startswith("step_") and ".tmp" not in name:
                try:
                    out.append(int(name[5:]))
                except ValueError:
                    pass
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def verify(self, step: int, check_payload: bool = True) -> Dict:
        """Validate one checkpoint: commit marker present and matching the
        manifest digest; every manifest leaf present in the payload with a
        matching CRC32.  Returns the parsed manifest, raises
        :class:`CheckpointCorrupt` otherwise.  ``check_payload=False``
        checks the commit marker only."""
        path = self._ckpt_dir(step)
        mpath = os.path.join(path, "manifest.json")
        cpath = os.path.join(path, "COMMIT")
        if not os.path.isdir(path):
            raise CheckpointCorrupt(f"no checkpoint at {path}", step, path)
        try:
            with open(mpath) as f:
                manifest = json.load(f)
        except (OSError, ValueError) as e:
            raise CheckpointCorrupt(
                f"step {step}: unreadable manifest ({e})", step, path) from e
        if manifest.get("version", 1) >= 2:
            try:
                with open(cpath) as f:
                    commit = f.read().strip()
            except OSError as e:
                raise CheckpointCorrupt(
                    f"step {step}: missing COMMIT marker (half-written "
                    "checkpoint?)", step, path) from e
            if commit != _manifest_digest(manifest):
                raise CheckpointCorrupt(
                    f"step {step}: manifest digest mismatch", step, path)
        if not check_payload:
            return manifest
        try:
            with np.load(os.path.join(path, "arrays.npz")) as data:
                for name, info in manifest["leaves"].items():
                    if info["file_key"] not in data.files:
                        raise CheckpointCorrupt(
                            f"step {step}: payload missing leaf {name!r}",
                            step, path)
                    arr = data[info["file_key"]]
                    crc = info.get("crc32")
                    if crc is not None and _crc(arr) != crc:
                        raise CheckpointCorrupt(
                            f"step {step}: CRC mismatch on leaf {name!r}",
                            step, path)
        except CheckpointCorrupt:
            raise
        except Exception as e:                   # zip/npz decode errors
            raise CheckpointCorrupt(
                f"step {step}: unreadable payload ({e})", step, path) from e
        return manifest

    def restore(self, step: int, target: Tree,
                verify: bool = True) -> Tuple[Tree, Dict]:
        """Rebuild a ``target``-structured tree from disk, each tensor leaf
        on its target's device.  Shapes and dtypes must match the target's
        (no silent casts).  With ``verify`` (default) the commit marker and
        CRCs are checked first; corruption raises
        :class:`CheckpointCorrupt`."""
        self._reading.add(step)                 # rotation must not delete us
        try:
            return self._restore_inner(step, target, verify)
        finally:
            self._reading.discard(step)

    def _restore_inner(self, step, target, verify):
        path = self._ckpt_dir(step)
        if verify:
            manifest = self.verify(step)
        else:
            with open(os.path.join(path, "manifest.json")) as f:
                manifest = json.load(f)
        leaves = []
        with np.load(os.path.join(path, "arrays.npz")) as data:
            for name, leaf in _flatten(target):
                info = manifest["leaves"].get(name)
                if info is None:
                    raise KeyError(f"checkpoint missing leaf {name!r}")
                arr = data[info["file_key"]]
                shape = list(getattr(leaf, "shape", np.shape(leaf)))
                if list(arr.shape) != shape:
                    raise ValueError(
                        f"shape mismatch for {name}: ckpt {arr.shape} vs "
                        f"target {tuple(shape)}")
                want = _np_dtype_name(leaf)
                if info["dtype"] != want:
                    # int8 payloads / fp32 sidecars come back as stored: a
                    # cast here would break bit-exact resume
                    raise ValueError(f"dtype mismatch for {name}: ckpt "
                                     f"{info['dtype']} vs target {want}")
                if not isinstance(leaf, torch.Tensor):
                    leaves.append(arr)
                    continue
                t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16) \
                    if want == "bfloat16" else torch.from_numpy(arr)
                leaves.append(t.to(leaf.device))
        return _unflatten(target, leaves), manifest["metadata"]

    def restore_latest(self, target: Tree) -> Tuple[Tree, Dict, int]:
        """Restore the newest intact checkpoint, falling back through the
        rotation when verification fails.  Returns ``(tree, metadata,
        step)``; raises :class:`CheckpointCorrupt` when none survives."""
        steps = self.all_steps()
        errors: List[str] = []
        for step in reversed(steps):
            try:
                tree, meta = self.restore(step, target)
                return tree, meta, step
            except CheckpointCorrupt as e:
                errors.append(str(e))
        raise CheckpointCorrupt(
            "no intact checkpoint in "
            f"{self.directory!r} (candidates: {steps}); "
            + "; ".join(errors) if errors else
            f"no checkpoint in {self.directory!r}")
