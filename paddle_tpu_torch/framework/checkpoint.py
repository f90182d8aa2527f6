"""Checkpoints: whole state dicts on one device, step snapshots in the
background, epoch-range resume.

Counterpart: ``paddle_tpu/framework/checkpoint.py``. The reference hands
its array IO to orbax; the port has no orbax, so it stores each leaf in
a file of its own, the raw bytes of the tensor (C order), with the
leaf's name, shape, dtype and file in an index (``index.json``) written
after every leaf file: the index is the commit marker a torn write can
never have. Reading is ``numpy.fromfile`` viewed as the leaf's torch
dtype, so bfloat16 and float8 leaves need nothing numpy lacks.

- `save_sharded` / `load_sharded` write and read one state dict on one
  device, through a ``.tmp`` scratch directory renamed into place (a
  crash leaves the previous checkpoint or the new one, never a torn
  one; `_recover_interrupted_swap` adopts a ``.tmp`` or ``.old`` only
  when its index exists). ``load_sharded(mesh_shardings=)`` raises: a
  device mesh is ROADMAP A12. The port does not read the reference's
  orbax step directories (ROADMAP A14); `io.save` / `io.load` files go
  both ways.
- `CheckpointManager` — step snapshots committed on a background thread
  (`observability.threads.guarded_target`; a dying commit is counted,
  never silent), so the train step does not wait for the disk. One
  snapshot in flight at most; keep-last-N retention; an integrity
  manifest (leaf names, shapes and dtypes, size and CRC32 of every file)
  written last inside the scratch directory before the atomic rename;
  `restore_latest` walks the committed steps newest first and returns
  the first that passes `validate_checkpoint` (each leaf read once, its
  CRC taken over the bytes read), counting the torn or corrupt ones on
  ``train_checkpoints_discarded_total``.
- `TrainEpochRange` — epoch-granular resume (the reference's
  ``auto_checkpoint`` counterpart): the model through `save_sharded`,
  the optimizer's ``state_dict()`` through `io.save` into a temporary
  file renamed into place; a torn optimizer file fails typed
  (`CheckpointCorruptError`).

Layout of a manager's step::

    <directory>/step_00000042/
        arrays/leaf_00000.bin ...   # one file a leaf, raw bytes
        arrays/index.json           # name -> file, shape, dtype (last)
        loop_state.json             # step counter, seed, data cursor...
        manifest.json               # leaf spec + per-file CRC (last)
"""
from __future__ import annotations

import json
import os
import re
import shutil
import threading
import time
import zlib

import numpy as np
import torch

MANIFEST_NAME = "manifest.json"
MANIFEST_SCHEMA = "paddle_tpu_torch.checkpoint_manifest/v1"
LOOP_STATE_NAME = "loop_state.json"
#: written last in a directory of leaves: the commit marker
INDEX_NAME = "index.json"
_LEAF_PREFIX = "leaf_"
#: bytes a write (and a CRC update) takes at a time
_CHUNK = 1 << 24


class CheckpointError(RuntimeError):
    """Base of the typed checkpoint error vocabulary."""


class CheckpointCorruptError(CheckpointError):
    """A checkpoint failed integrity validation (torn write, byte
    corruption, manifest mismatch) — restore must fall back to an
    older checkpoint, never return garbage."""


def _dtype_name(dtype) -> str:
    """A torch or numpy dtype by the name both use (``float32``,
    ``bfloat16``, ``int64``, ``bool``)."""
    if isinstance(dtype, torch.dtype):
        return str(dtype).removeprefix("torch.")
    return str(np.dtype(dtype))


def _host(v) -> torch.Tensor:
    """A leaf (tensor or numpy array) as a contiguous CPU tensor."""
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().contiguous()
    return torch.from_numpy(np.ascontiguousarray(v))


def _write_leaves(dirpath, arrays) -> dict:
    """One raw file a leaf under ``dirpath``, then the index, last.
    Returns ``{relative path: {"size", "crc32"}}`` of the leaf files,
    computed from the bytes as they were written."""
    os.makedirs(dirpath, exist_ok=True)
    index, files = {}, {}
    for i, (name, v) in enumerate(arrays.items()):
        t = _host(v)
        fn = f"{_LEAF_PREFIX}{i:05d}.bin"
        buf = memoryview(t.reshape(-1).view(torch.uint8).numpy())
        crc = 0
        with open(os.path.join(dirpath, fn), "wb") as f:
            for off in range(0, len(buf), _CHUNK):
                part = buf[off:off + _CHUNK]
                f.write(part)
                crc = zlib.crc32(part, crc)
        index[name] = {"file": fn, "shape": list(t.shape),
                       "dtype": _dtype_name(t.dtype)}
        files[fn] = {"size": len(buf), "crc32": crc}
    with open(os.path.join(dirpath, INDEX_NAME), "w") as f:
        json.dump(index, f)
    return files


def _read_leaves(dirpath, crcs=None) -> dict:
    """name -> CPU tensor of a directory `_write_leaves` committed. With
    ``crcs`` (leaf file -> CRC32), each file's CRC is taken over the
    bytes as read, so a restore reads every file once; a mismatch raises
    `CheckpointCorruptError`."""
    with open(os.path.join(dirpath, INDEX_NAME)) as f:
        index = json.load(f)
    out = {}
    for name, spec in index.items():
        raw = np.fromfile(os.path.join(dirpath, spec["file"]), dtype=np.uint8)
        if crcs is not None and zlib.crc32(raw) != crcs.get(spec["file"]):
            raise CheckpointCorruptError(
                f"{dirpath}: {spec['file']} CRC mismatch (corrupt shard)")
        out[name] = torch.from_numpy(raw).view(
            getattr(torch, spec["dtype"])).reshape(spec["shape"])
    return out


def _is_leaf(rel) -> bool:
    """Is a manifest path (relative to a manager's step) a leaf file?"""
    return rel.startswith("arrays" + os.sep + _LEAF_PREFIX)


def _committed(path) -> bool:
    """Was this directory of leaves finished? A crash mid-write leaves
    leaf files without the index written last."""
    return os.path.exists(os.path.join(path, INDEX_NAME))


def _spec(v) -> tuple:
    return (tuple(int(s) for s in v.shape), _dtype_name(v.dtype))


def save_sharded(state_dict, path, step=None, overwrite=True):
    """Write a state dict (name -> tensor or numpy array) to ``path``
    (``path/step_<step>`` with ``step``) through a scratch directory
    renamed into place; returns the path."""
    path = os.path.abspath(path)
    if step is not None:
        path = os.path.join(path, f"step_{step}")
    if os.path.exists(path) and not overwrite:
        raise FileExistsError(f"checkpoint exists: {path}")
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    # never delete the previous checkpoint before the new one is whole
    tmp, old = path + ".tmp", path + ".old"
    shutil.rmtree(tmp, ignore_errors=True)
    try:
        _write_leaves(tmp, state_dict)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    shutil.rmtree(old, ignore_errors=True)
    if os.path.exists(path):
        os.replace(path, old)
    os.replace(tmp, path)
    shutil.rmtree(old, ignore_errors=True)
    return path


def _recover_interrupted_swap(path):
    """If a save crashed mid-swap, the newest whole checkpoint survives
    as ``.tmp`` or the previous one as ``.old`` — rename it back into
    place. A candidate is adopted ONLY if its index exists: a crash
    during the write leaves a partial ``.tmp`` with none, and renaming
    that over a valid ``.old`` would trade a good checkpoint for
    garbage."""
    if os.path.exists(path):
        return
    for cand in (path + ".tmp", path + ".old"):
        if os.path.exists(cand) and _committed(cand):
            os.replace(cand, path)
            return


def load_sharded(path, template=None, mesh_shardings=None, device="cpu"):
    """Read a state dict `save_sharded` wrote: name -> tensor on
    ``device`` (the CPU by default, as ``torch.load``), or, with
    ``template`` (name -> tensor), on each template tensor's device,
    its names, shapes and dtypes checked (`CheckpointCorruptError`)."""
    if mesh_shardings is not None:
        raise NotImplementedError(
            "restoring onto a device mesh (mesh_shardings=) is a later "
            "slice (ROADMAP A12); the port restores on one device")
    path = os.path.abspath(path)
    _recover_interrupted_swap(path)
    arrays = _read_leaves(path)
    if template is None:
        return {k: v.to(device) for k, v in arrays.items()}
    if set(template) != set(arrays):
        raise CheckpointCorruptError(
            f"{path}: leaf set mismatch "
            f"({sorted(set(template) ^ set(arrays))[:4]}...)")
    out = {}
    for k, like in template.items():
        if _spec(arrays[k]) != _spec(like):
            raise CheckpointCorruptError(
                f"{path}: leaf {k!r} is {_spec(arrays[k])}, the template "
                f"wants {_spec(like)}")
        out[k] = arrays[k].to(getattr(like, "device", device))
    return out


# ---------------------------------------------------------------------------
# integrity manifest
# ---------------------------------------------------------------------------

def _crc32(path) -> int:
    acc = 0
    with open(path, "rb") as f:
        while True:
            b = f.read(_CHUNK)
            if not b:
                return acc
            acc = zlib.crc32(b, acc)


def write_manifest(ckpt_dir, step, arrays, known=None) -> str:
    """Write the integrity manifest INSIDE ``ckpt_dir``, last: leaf
    names/shapes/dtypes plus size+CRC32 of every file already in the
    dir. ``known``: ``{relative path: {"size", "crc32"}}`` already
    computed while writing (the rest are read back). Written after all
    data files, before the atomic dir swap — so manifest presence +
    per-file CRC is the checkpoint's own proof of wholeness."""
    known = known or {}
    files = {}
    for root, _, names in os.walk(ckpt_dir):
        for fn in names:
            if fn == MANIFEST_NAME:
                continue
            p = os.path.join(root, fn)
            rel = os.path.relpath(p, ckpt_dir)
            files[rel] = known.get(rel) or {"size": os.path.getsize(p),
                                            "crc32": _crc32(p)}
    manifest = {
        "schema": MANIFEST_SCHEMA,
        "step": int(step),
        "wall_time": time.time(),
        "leaves": {k: {"shape": list(_spec(v)[0]), "dtype": _spec(v)[1]}
                   for k, v in arrays.items()},
        "files": files,
    }
    mpath = os.path.join(ckpt_dir, MANIFEST_NAME)
    with open(mpath, "w") as f:
        json.dump(manifest, f)
    return mpath


def validate_checkpoint(ckpt_dir, template=None):
    """Raise `CheckpointCorruptError` unless ``ckpt_dir`` is a whole,
    uncorrupted manager checkpoint: manifest present and parseable, the
    index (commit marker) present in ``arrays/``, every manifest file
    matching its recorded size and CRC32, and — when ``template`` (name
    -> anything with ``shape`` and ``dtype``) is given — leaf names,
    shapes and dtypes matching the restore target. Returns the
    manifest."""
    return _validate(ckpt_dir, template, crc_leaves=True)


def _validate(ckpt_dir, template, crc_leaves):
    """`validate_checkpoint`; without ``crc_leaves`` the leaf files'
    CRCs are left to the read that follows (`_read_leaves`)."""
    mpath = os.path.join(ckpt_dir, MANIFEST_NAME)
    if not os.path.exists(mpath):
        raise CheckpointCorruptError(f"{ckpt_dir}: no manifest (torn write)")
    try:
        with open(mpath) as f:
            manifest = json.load(f)
    except (ValueError, OSError) as e:
        raise CheckpointCorruptError(
            f"{ckpt_dir}: unreadable manifest: {e!r}") from e
    if not _committed(os.path.join(ckpt_dir, "arrays")):
        raise CheckpointCorruptError(
            f"{ckpt_dir}: commit marker missing (torn array write)")
    for rel, info in manifest.get("files", {}).items():
        p = os.path.join(ckpt_dir, rel)
        if not os.path.exists(p):
            raise CheckpointCorruptError(f"{ckpt_dir}: missing file {rel}")
        if os.path.getsize(p) != info["size"]:
            raise CheckpointCorruptError(
                f"{ckpt_dir}: {rel} size {os.path.getsize(p)} != recorded "
                f"{info['size']}")
        if (crc_leaves or not _is_leaf(rel)) and _crc32(p) != info["crc32"]:
            raise CheckpointCorruptError(
                f"{ckpt_dir}: {rel} CRC mismatch (corrupt shard)")
    if template is not None:
        want = {k: _spec(v) for k, v in template.items()}
        got = {k: (tuple(m["shape"]), m["dtype"])
               for k, m in manifest.get("leaves", {}).items()}
        if set(want) != set(got):
            missing = set(want) ^ set(got)
            raise CheckpointCorruptError(
                f"{ckpt_dir}: leaf set mismatch ({sorted(missing)[:4]}...)")
        for k in want:
            if want[k] != got[k]:
                raise CheckpointCorruptError(
                    f"{ckpt_dir}: leaf {k!r} is {got[k]}, restore target "
                    f"wants {want[k]}")
    return manifest


def is_valid_checkpoint(ckpt_dir, template=None) -> bool:
    try:
        validate_checkpoint(ckpt_dir, template)
        return True
    except CheckpointCorruptError:
        return False


# ---------------------------------------------------------------------------
# async snapshot checkpoint manager
# ---------------------------------------------------------------------------

_STEP_DIR_RE = re.compile(r"^step_(\d{8,})$")  # :08d does not truncate >1e8


class CheckpointManager:
    """Step-granular snapshot checkpoints with an async commit thread.

    The caller (normally `ResilientTrainLoop`) copies the device state
    to the host at a step boundary (`SpmdTrainStep.host_state`) and
    hands the dict here; `save` returns at once and the leaf files,
    manifest and atomic directory rename run on a background thread.
    The train step therefore overlaps the checkpoint IO; the memory
    cost is one host copy of params and slots (the snapshot the thread
    owns) besides the one being taken.

    ``keep`` bounds retention (oldest committed dirs pruned after each
    commit); `restore_latest` walks committed steps newest-first and
    returns the first that passes `validate_checkpoint`, counting the
    torn/corrupt ones on ``train_checkpoints_discarded_total``.
    """

    def __init__(self, directory, keep=3, async_commit=True,
                 fault_injector=None, loop_id="train0", registry=None):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.keep = int(keep)
        self.async_commit = bool(async_commit)
        self.loop_id = loop_id
        self._injector = fault_injector
        self._pending: threading.Thread | None = None
        self._lock = threading.Lock()
        from .train_loop import register_train_metrics
        self._m = register_train_metrics(registry)
        #: commit exceptions (repr) in order; the commit thread never
        #: raises into the train loop
        self.commit_errors: list = []

    # -- save ------------------------------------------------------------
    def _step_dir(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{int(step):08d}")

    def save(self, step, arrays, loop_state, block=False):
        """Commit one snapshot. ``arrays``: flat name -> HOST tensor (or
        numpy array) dict the caller already copied off the device;
        ``loop_state``: a JSON-able dict captured at the same boundary.
        Returns immediately unless ``block`` (or the manager is
        synchronous); at most one commit is in flight — a second `save`
        first waits out the previous one (bounded memory)."""
        from ..observability.threads import guarded_target

        self.wait()
        if block or not self.async_commit:
            self._commit(int(step), arrays, loop_state)
            return
        t = threading.Thread(
            target=guarded_target(f"ckpt-commit[{self.loop_id}]",
                                  self._commit),
            args=(int(step), arrays, loop_state),
            name=f"ckpt-commit-{step}", daemon=True)
        with self._lock:
            self._pending = t
        t.start()

    def wait(self):
        """Join the in-flight commit, if any."""
        with self._lock:
            t = self._pending
        if t is not None:
            t.join()
            with self._lock:
                if self._pending is t:
                    self._pending = None

    def _commit(self, step, arrays, loop_state):
        t0 = time.perf_counter()
        inj = self._injector
        if inj is not None:
            delay = inj.io_delay_s(step)
            if delay:
                time.sleep(delay)  # bounded: the injected stall always ends
        path = self._step_dir(step)
        tmp = path + ".tmp"
        shutil.rmtree(tmp, ignore_errors=True)
        try:
            if inj is not None and inj.torn_write(step):
                # the commit thread "dies" mid-write: partial leaf
                # bytes, no index, no manifest, NO swap — what a kill
                # during IO leaves on disk
                os.makedirs(os.path.join(tmp, "arrays"), exist_ok=True)
                with open(os.path.join(tmp, "arrays", "leaf.partial"),
                          "wb") as f:
                    f.write(b"\x00" * 64)
                self._m["discarded"].inc(loop=self.loop_id)
                return
            os.makedirs(tmp, exist_ok=True)
            known = _write_leaves(os.path.join(tmp, "arrays"), arrays)
            with open(os.path.join(tmp, LOOP_STATE_NAME), "w") as f:
                json.dump(loop_state, f)
            write_manifest(tmp, step, arrays, known={
                os.path.join("arrays", k): v for k, v in known.items()})
            shutil.rmtree(path, ignore_errors=True)  # re-save of same step
            os.replace(tmp, path)
        except BaseException as e:
            self.commit_errors.append(repr(e))
            self._m["discarded"].inc(loop=self.loop_id)
            shutil.rmtree(tmp, ignore_errors=True)
            raise
        if inj is not None and inj.corrupt_shard(step):
            _flip_one_byte(os.path.join(path, "arrays"))
        self._m["committed"].inc(loop=self.loop_id)
        self._m["last_committed"].set(step, loop=self.loop_id)
        self._m["write_seconds"].observe(time.perf_counter() - t0,
                                         loop=self.loop_id)
        self._prune()

    def _prune(self):
        steps = self.steps()
        for s in steps[:-self.keep] if self.keep > 0 else []:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)

    # -- restore ---------------------------------------------------------
    def steps(self) -> list:
        """Committed step indices, ascending (tmp scratch excluded)."""
        out = []
        for name in os.listdir(self.directory):
            m = _STEP_DIR_RE.match(name)
            if m:
                out.append(int(m.group(1)))
        return sorted(out)

    def last_committed_step(self):
        steps = self.steps()
        return steps[-1] if steps else None

    def restore_latest(self, template=None):
        """(step, arrays, loop_state) from the newest checkpoint that
        passes integrity validation, skipping (and counting on
        ``train_checkpoints_discarded_total``) torn or corrupt ones;
        None when no valid checkpoint exists. ``arrays`` come back as
        CPU tensors — the caller copies them into its live state."""
        self.wait()
        for step in reversed(self.steps()):
            path = self._step_dir(step)
            try:
                manifest = _validate(path, template, crc_leaves=False)
                arrays = _read_leaves(os.path.join(path, "arrays"), {
                    os.path.basename(rel): info["crc32"]
                    for rel, info in manifest["files"].items()
                    if _is_leaf(rel)})
            except CheckpointCorruptError:
                self._m["discarded"].inc(loop=self.loop_id)
                continue
            with open(os.path.join(path, LOOP_STATE_NAME)) as f:
                loop_state = json.load(f)
            return step, arrays, loop_state
        return None


def _flip_one_byte(root):
    """Corrupt the largest regular file under ``root`` in place (the
    corrupt_shard injection: CRC must catch it, size stays equal)."""
    best, size = None, -1
    for dirpath, _, names in os.walk(root):
        for fn in names:
            p = os.path.join(dirpath, fn)
            s = os.path.getsize(p)
            if s > size:
                best, size = p, s
    if best is None or size == 0:
        return
    with open(best, "r+b") as f:
        f.seek(size // 2)
        b = f.read(1)
        f.seek(size // 2)
        f.write(bytes([b[0] ^ 0xFF]))


class TrainEpochRange:
    """Auto-checkpoint over an epoch range (the reference's
    ``TrainEpochRange``, a local or NFS directory here): iterating yields
    only epochs not yet completed; `save` records (epoch, state);
    restart resumes after the last saved epoch."""

    def __init__(self, max_epoch_num, name, checkpoint_path=None,
                 save_checkpoint_inter=1):
        self.max_epoch_num = max_epoch_num
        self.name = re.sub(r"[^\w.-]", "_", name)
        root = checkpoint_path or os.environ.get(
            "PADDLE_CHECKPOINT_DIR",
            os.path.expanduser("~/.cache/paddle_tpu_torch/ckpt"))
        self.dir = os.path.join(root, self.name)
        os.makedirs(self.dir, exist_ok=True)
        self.save_inter = save_checkpoint_inter
        self._meta_path = os.path.join(self.dir, "meta.json")
        self._restored_epoch = -1
        if os.path.exists(self._meta_path):
            with open(self._meta_path) as f:
                self._restored_epoch = json.load(f)["epoch"]

    @property
    def restored_epoch(self):
        return self._restored_epoch

    def get(self):
        """Epochs still to run (resume-aware)."""
        for e in range(self._restored_epoch + 1, self.max_epoch_num):
            yield e

    def save(self, epoch, state_dict=None, optimizer=None):
        if ((epoch + 1) % self.save_inter != 0
                and epoch != self.max_epoch_num - 1):
            return
        if state_dict is not None:
            save_sharded(state_dict, os.path.join(self.dir, "model"))
        if optimizer is not None:
            from .io import save as psave
            # tmp + atomic rename: a crash mid-write must not leave
            # meta.json pointing at a truncated optimizer file
            p = os.path.join(self.dir, "opt.pdopt")
            tmp = p + ".tmp"
            psave(optimizer.state_dict(), tmp)
            os.replace(tmp, p)
        tmp = self._meta_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"epoch": epoch, "time": time.time()}, f)
        os.replace(tmp, self._meta_path)  # atomic commit, crash-safe

    def load_model(self, template=None, mesh_shardings=None):
        p = os.path.join(self.dir, "model")
        _recover_interrupted_swap(p)
        if not os.path.exists(p):
            if self._restored_epoch >= 0:
                import warnings
                warnings.warn(
                    f"meta.json records epoch {self._restored_epoch} but no "
                    f"model checkpoint exists at {p}; resuming would use "
                    "fresh weights", RuntimeWarning)
            return None
        return load_sharded(p, template, mesh_shardings)

    def load_optimizer_state(self):
        from .io import load as pload
        p = os.path.join(self.dir, "opt.pdopt")
        if not os.path.exists(p):
            return None
        try:
            return pload(p)
        except Exception as e:  # noqa: BLE001 - any unpickle failure = torn
            raise CheckpointCorruptError(
                f"optimizer checkpoint {p} is torn or corrupt "
                f"({type(e).__name__}: {e}); delete it or restore an older "
                "checkpoint") from e


__all__ = ["CheckpointError", "CheckpointCorruptError", "CheckpointManager",
           "TrainEpochRange", "save_sharded", "load_sharded",
           "write_manifest", "validate_checkpoint", "is_valid_checkpoint"]
