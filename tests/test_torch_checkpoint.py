"""The port's checkpoints (`paddle_tpu_torch.framework.checkpoint`): the
reference's ``tests/test_checkpoint.py`` cases on the port's own format
(one raw file a leaf, an index written last as the commit marker), and
the manager's manifest and CRC checks.

Data comes from numpy seeds. The optimizer file `TrainEpochRange` writes
goes through `io.save`, so paddle_tpu's ``load`` reads it too.
"""
import json
import os

import numpy as np
import pytest
import torch

from paddle_tpu_torch.framework import io as tio
from paddle_tpu_torch.framework.checkpoint import (
    INDEX_NAME, MANIFEST_NAME, CheckpointCorruptError, CheckpointManager,
    TrainEpochRange, _flip_one_byte, is_valid_checkpoint, load_sharded,
    save_sharded, validate_checkpoint)
from paddle_tpu_torch.framework.train_faults import TrainFaultInjector
from paddle_tpu_torch.framework.train_loop import register_train_metrics
from paddle_tpu_torch.nn import Linear
from paddle_tpu_torch.optimizer import AdamW


def _linear(seed, n_in=4, n_out=3):
    lin = Linear(n_in, n_out, device="cpu")
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        lin.weight.copy_(torch.from_numpy(
            rng.standard_normal((n_in, n_out)).astype(np.float32)))
        lin.bias.copy_(torch.from_numpy(
            rng.standard_normal(n_out).astype(np.float32)))
    return lin


def _state(seed=0):
    """One leaf of each dtype the training state holds."""
    rng = np.random.default_rng(seed)
    w = torch.from_numpy(rng.standard_normal((4, 6)).astype(np.float32))
    return {"w": w, "w_bf16": w.to(torch.bfloat16),
            "step": torch.tensor(7, dtype=torch.int32),
            "ids": torch.from_numpy(rng.integers(0, 9, 5)),
            "mask": torch.from_numpy(rng.random(3) < 0.5),
            "scale": torch.tensor(1024.0)}


def _equal(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape
    assert torch.equal(a, b)


def test_save_load_roundtrip(tmp_path):
    state = dict(_linear(0).state_dict())
    state.update(_state())
    p = save_sharded(state, str(tmp_path / "ckpt"))
    restored = load_sharded(p)
    assert set(restored) == set(state)
    for k, v in state.items():
        _equal(restored[k], v.detach())


def test_load_onto_a_mesh_is_a_later_slice_and_a_template_is_checked(
        tmp_path):
    """The reference's re-sharding restore needs a mesh (ROADMAP A12);
    a template restores onto its tensors' devices and checks names,
    shapes and dtypes, typed."""
    w = torch.arange(32, dtype=torch.float32).reshape(8, 4)
    p = save_sharded({"w": w}, str(tmp_path / "ckpt"))
    with pytest.raises(NotImplementedError, match="A12"):
        load_sharded(p, template={"w": w}, mesh_shardings={"w": object()})
    _equal(load_sharded(p, template={"w": torch.zeros(8, 4)})["w"], w)
    with pytest.raises(CheckpointCorruptError):
        load_sharded(p, template={"w": torch.zeros(4, 8)})
    with pytest.raises(CheckpointCorruptError):
        load_sharded(p, template={"w": torch.zeros(8, 4,
                                                   dtype=torch.bfloat16)})
    with pytest.raises(CheckpointCorruptError):
        load_sharded(p, template={"v": w})


def test_train_epoch_range_resume(tmp_path):
    name = "job1"
    r1 = TrainEpochRange(5, name, checkpoint_path=str(tmp_path))
    seen = []
    net = _linear(1, 2, 2)
    for e in r1.get():
        seen.append(e)
        r1.save(e, net.state_dict())
        if e == 2:
            break  # simulated crash after epoch 2 committed
    assert seen == [0, 1, 2]

    r2 = TrainEpochRange(5, name, checkpoint_path=str(tmp_path))
    assert r2.restored_epoch == 2
    assert list(r2.get()) == [3, 4]
    restored = r2.load_model()
    for k, v in net.state_dict().items():
        _equal(restored[k], v)


def test_epoch_range_save_interval(tmp_path):
    r = TrainEpochRange(4, "job2", checkpoint_path=str(tmp_path),
                        save_checkpoint_inter=2)
    net = _linear(2, 2, 2)
    r.save(0, net.state_dict())  # (0+1)%2 != 0 -> skipped
    assert not os.path.exists(os.path.join(r.dir, "meta.json"))
    r.save(1, net.state_dict())  # saved
    assert os.path.exists(os.path.join(r.dir, "meta.json"))


def test_recover_never_adopts_torn_tmp(tmp_path):
    """A crash DURING the leaf write leaves a partial .tmp with no index;
    recovery falls back to the valid .old instead of renaming garbage
    into place. A whole .tmp (index present) is the newest checkpoint and
    is adopted."""
    w = torch.arange(8, dtype=torch.float32).reshape(2, 4)
    p = str(tmp_path / "ckpt")
    save_sharded({"w": w}, p)
    os.replace(p, p + ".old")
    os.makedirs(p + ".tmp")
    with open(os.path.join(p + ".tmp", "leaf_00000.bin"), "wb") as f:
        f.write(b"\x00" * 32)  # no index.json: torn
    _equal(load_sharded(p)["w"], w)
    w2 = torch.ones(2, 4)
    p2 = str(tmp_path / "ckpt2")
    save_sharded({"w": w2}, p2)
    os.replace(p2, p2 + ".tmp")
    _equal(load_sharded(p2)["w"], w2)


def test_optimizer_save_is_atomic_and_torn_load_is_typed(tmp_path):
    """`TrainEpochRange.save` writes opt.pdopt via tmp + os.replace, and a
    truncated file fails typed instead of returning garbage. The file is
    `io.save`'s format: paddle_tpu's ``load`` reads it."""
    from paddle_tpu.framework import io as jio

    net = _linear(3, 2, 2)
    opt = AdamW(learning_rate=1e-3, parameters=net.parameters())
    net(torch.ones(1, 2)).sum().backward()
    opt.step()
    r = TrainEpochRange(3, "job3", checkpoint_path=str(tmp_path))
    r.save(0, net.state_dict(), optimizer=opt)
    p = os.path.join(r.dir, "opt.pdopt")
    assert os.path.exists(p) and not os.path.exists(p + ".tmp")
    sd = r.load_optimizer_state()
    want = opt.state_dict()
    assert set(sd) == set(want)
    for k, v in want.items():
        if isinstance(v, torch.Tensor):
            _equal(sd[k], v)
    ref = jio.load(p, return_numpy=True)
    for k, v in want.items():
        if isinstance(v, torch.Tensor):
            np.testing.assert_array_equal(ref[k], v.numpy())
    with open(p, "r+b") as f:  # truncate mid-file: a torn write
        f.truncate(os.path.getsize(p) // 2)
    with pytest.raises(CheckpointCorruptError):
        r.load_optimizer_state()


def test_manager_roundtrips_every_dtype_with_its_manifest(tmp_path):
    """Leaves come back bit for bit; the manifest lists every leaf's
    shape and dtype and every file's size and CRC32; the index is the
    leaves' commit marker."""
    import zlib

    state = _state(5)
    mgr = CheckpointManager(str(tmp_path), loop_id="t-man")
    mgr.save(3, state, {"step": 3, "data_cursor": 3}, block=True)
    path = mgr._step_dir(3)
    with open(os.path.join(path, MANIFEST_NAME)) as f:
        manifest = json.load(f)
    assert manifest["step"] == 3
    assert manifest["leaves"]["w_bf16"] == {"shape": [4, 6],
                                            "dtype": "bfloat16"}
    assert manifest["leaves"]["mask"]["dtype"] == "bool"
    assert os.path.exists(os.path.join(path, "arrays", INDEX_NAME))
    for rel, info in manifest["files"].items():
        with open(os.path.join(path, rel), "rb") as f:
            data = f.read()
        assert info == {"size": len(data), "crc32": zlib.crc32(data)}
    step, arrays, loop_state = mgr.restore_latest(template=state)
    assert step == 3 and loop_state == {"step": 3, "data_cursor": 3}
    for k, v in state.items():
        _equal(arrays[k], v)


def test_checkpoint_manager_validation_rejects_tampering(tmp_path):
    """validate_checkpoint: CRC catches byte flips, a template mismatch
    is typed, a missing manifest reads as a torn write."""
    mgr = CheckpointManager(str(tmp_path), loop_id="t-val")
    arrays = {"w": np.arange(16, dtype=np.float32).reshape(4, 4)}
    mgr.save(3, arrays, {"step": 3, "data_cursor": 3}, block=True)
    path = mgr._step_dir(3)
    validate_checkpoint(path, template=arrays)  # whole: passes
    with pytest.raises(CheckpointCorruptError):
        validate_checkpoint(
            path, template={"w": np.zeros((2, 2), np.float32)})
    with pytest.raises(CheckpointCorruptError):
        validate_checkpoint(path, template={
            "w": torch.zeros(4, 4, dtype=torch.int32)})
    _flip_one_byte(os.path.join(path, "arrays"))
    with pytest.raises(CheckpointCorruptError, match="CRC"):
        validate_checkpoint(path)
    assert mgr.restore_latest() is None
    os.remove(os.path.join(path, MANIFEST_NAME))
    with pytest.raises(CheckpointCorruptError, match="torn"):
        validate_checkpoint(path)
    assert not is_valid_checkpoint(path)


def test_restore_reads_each_leaf_file_once(tmp_path, monkeypatch):
    """restore_latest takes a leaf's CRC over the bytes it then returns
    (no second read of a leaf file for its CRC), and still discards a
    step whose leaf has a byte flipped."""
    from paddle_tpu_torch.framework import checkpoint as ck

    mgr = CheckpointManager(str(tmp_path), loop_id="t-once")
    for s in (2, 4):
        mgr.save(s, _state(s), {"step": s, "data_cursor": s}, block=True)
    crc_read = []
    real = ck._crc32
    monkeypatch.setattr(ck, "_crc32",
                        lambda p: crc_read.append(p) or real(p))
    step, arrays, _ = mgr.restore_latest(template=_state(4))
    assert step == 4
    for k, v in _state(4).items():
        _equal(arrays[k], v)
    assert crc_read and not any(
        os.path.basename(p).startswith("leaf_") for p in crc_read)
    _flip_one_byte(os.path.join(mgr._step_dir(4), "arrays"))
    step, arrays, _ = mgr.restore_latest()
    assert step == 2
    _equal(arrays["w_bf16"], _state(2)["w_bf16"])


def test_restore_skips_torn_and_corrupt_and_keeps_last_n(tmp_path):
    """A torn commit never swaps in; a corrupted latest is skipped at
    restore and counted on train_checkpoints_discarded_total; only the
    newest ``keep`` steps stay."""
    inj = (TrainFaultInjector().add("torn_checkpoint_write", at_step=4)
           .add("corrupt_shard", at_step=6))
    mgr = CheckpointManager(str(tmp_path), keep=2, fault_injector=inj,
                            loop_id="t-keep")
    disc = register_train_metrics()["discarded"]
    for s in (2, 4, 6):
        mgr.save(s, _state(s), {"step": s, "data_cursor": s})
    mgr.wait()
    assert mgr.steps() == [2, 6]
    assert os.path.exists(mgr._step_dir(4) + ".tmp")
    before = disc.value(loop="t-keep")
    step, arrays, _ = mgr.restore_latest()
    assert step == 2
    _equal(arrays["w_bf16"], _state(2)["w_bf16"])
    assert disc.value(loop="t-keep") == before + 1
    for s in (8, 10):
        mgr.save(s, _state(s), {"step": s, "data_cursor": s}, block=True)
    assert mgr.steps() == [8, 10]


def test_io_file_of_a_state_dict_and_a_checkpoint_agree(tmp_path):
    """The same state through `io.save` and through `save_sharded` reads
    back equal, bfloat16 included."""
    state = _state(9)
    tio.save(state, str(tmp_path / "s.pd"))
    save_sharded(state, str(tmp_path / "s_ckpt"))
    a = tio.load(str(tmp_path / "s.pd"))
    b = load_sharded(str(tmp_path / "s_ckpt"))
    for k in state:
        _equal(a[k].detach(), b[k])
