"""The port's checkpoint manager: twins of the manager tests of
``tests/test_checkpoint_data.py`` and of the registered-state tests of
``tests/test_streaming.py``, plus the on-disk layout shared with the
reference's manager, read and written both ways (CPU)."""
import os

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.checkpoint.manager import CheckpointManager as JManager
from repro_torch import _tree
from repro_torch.checkpoint.manager import (CheckpointManager, restore_tree,
                                            save_tree)
from repro_torch.core.metrics import CommLedger
from repro_torch.core.runtime import RunState


def _tree_(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"a": torch.randn((8, 4), generator=g),
            "nested": {"b": torch.arange(6, dtype=torch.int32),
                       "c": torch.ones((), dtype=torch.bfloat16)}}


def _assert_trees_equal(got, want):
    gl, wl = _tree.tree_leaves(got), _tree.tree_leaves(want)
    assert len(gl) == len(wl)
    for a, b in zip(gl, wl):
        assert a.dtype == b.dtype
        assert torch.equal(a, b)


def test_save_restore_roundtrip(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep_last=2)
    tree = _tree_()
    mgr.save(7, tree)
    got, step = mgr.restore(tree)
    assert step == 7
    _assert_trees_equal(got, tree)


def test_latest_step_and_retention(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep_last=2)
    tree = _tree_()
    for s in (1, 5, 9):
        mgr.save(s, tree)
    assert mgr.latest_step() == 9
    assert mgr.all_steps() == [5, 9]          # step 1 pruned


def test_pinned_step_survives_retention_churn(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep_last=2)
    tree = _tree_()
    mgr.save(1, tree)
    mgr.pin(1)
    for s in (2, 3, 4, 5, 6):
        mgr.save(s, tree)
    assert mgr.all_steps() == [1, 5, 6]       # pinned 1 outlives churn
    got, step = mgr.restore(tree, step=1)
    assert step == 1 and got is not None

    mgr2 = CheckpointManager(str(tmp_path), keep_last=2)   # durable pin
    assert mgr2.pinned_steps() == [1]
    mgr2.save(7, tree)
    assert 1 in mgr2.all_steps()
    mgr2.unpin(1)
    mgr2.unpin(1)                             # idempotent
    mgr2.save(8, tree)
    assert mgr2.all_steps() == [7, 8]


def test_corrupt_partial_checkpoint_ignored(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    tree = _tree_()
    mgr.save(3, tree)
    # a crashed writer leaves a .tmp and a manifest-less dir
    os.makedirs(tmp_path / "step_00000009.tmp")
    os.makedirs(tmp_path / "step_00000007")
    assert mgr.latest_step() == 3
    got, step = mgr.restore(tree)
    assert step == 3


def test_async_save_then_restore(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    tree = _tree_()
    mgr.save(2, tree, blocking=False)
    mgr.wait()
    got, step = mgr.restore(tree)
    assert step == 2
    _assert_trees_equal(got, tree)


def test_async_save_snapshots_on_the_calling_thread(tmp_path):
    """The run writes the next chunk's errors into its trace buffer in
    place as soon as save returns: the snapshot must already be a copy."""
    mgr = CheckpointManager(str(tmp_path))
    errs = torch.zeros(6)
    mgr.save(1, {"errs": errs}, blocking=False)
    errs[:] = 1.0                             # before the writer finishes
    mgr.wait()
    got, _ = mgr.restore({"errs": torch.empty(6)})
    assert torch.equal(got["errs"], torch.zeros(6))


def test_failed_async_save_raises_on_wait(tmp_path, monkeypatch):
    """A write that fails on the writer thread is not lost: the next wait
    (and so the next save, or the run's end) raises it."""
    from repro_torch.checkpoint import manager as mod

    def full_disk(*args):
        raise OSError("no space left on device")

    mgr = CheckpointManager(str(tmp_path))
    monkeypatch.setattr(mod, "_write", full_disk)
    mgr.save(1, _tree_(), blocking=False)
    with pytest.raises(OSError, match="no space"):
        mgr.wait()
    mgr.wait()                                # reported once
    assert mgr.latest_step() is None


def test_restore_tree_mismatch_raises(tmp_path):
    p = str(tmp_path / "snap")
    save_tree(p, _tree_(), 0)
    with pytest.raises(ValueError):
        restore_tree(p, {"different": torch.zeros(3)})


def test_restore_empty_returns_none(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    got, step = mgr.restore(_tree_())
    assert got is None and step is None


def test_ledger_checkpoints_as_tree_node(tmp_path):
    """Twin of test_ledger_checkpoints_as_pytree: counters past 2^24 come
    back exactly and the list-valued awake_counts is rebuilt."""
    led = CommLedger(p2p=123456789.0, matrices=10.0, scalars=9.876543219e12,
                     awake_counts=[3, 4, 5], payload_bytes=7.0)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, {"ledger": led})
    got, _ = mgr.restore({"ledger": CommLedger()})
    restored = got["ledger"]
    assert restored == led
    restored.awake_counts.append(7)           # a plain list again
    assert restored.awake_counts == [3, 4, 5, 7]


def test_runstate_is_a_tree_node():
    st = RunState(q=torch.zeros((2, 3, 1)),
                  key=torch.zeros((2,), dtype=torch.uint32),
                  step=torch.tensor(4, dtype=torch.int32), errs=torch.zeros(7),
                  sends=torch.zeros((7, 2)), counts=torch.zeros((7, 2)))
    names, leaves, _ = _tree.flatten_with_names(st)
    assert names == ["0", "1", "2", "3", "4", "5"]
    st2 = _tree.unflatten(_tree.flatten_with_names(st)[2], leaves)
    assert isinstance(st2, RunState) and int(st2.step) == 4
    nested = RunState(q=(torch.zeros(2), torch.zeros(3), torch.tensor(0)),
                      key=st.key, step=st.step, errs=st.errs,
                      sends=st.sends, counts=st.counts)
    assert _tree.flatten_with_names(nested)[0][:3] == ["0/0", "0/1", "0/2"]


def test_reference_manager_reads_what_the_port_wrote(tmp_path):
    """Same layout and leaf names: the reference restores a port step,
    bf16 included (stored as uint16 bits, "bfloat16" in the manifest)."""
    tree = _tree_()
    CheckpointManager(str(tmp_path)).save(4, tree)
    like = {"a": jnp.zeros((8, 4)),
            "nested": {"b": jnp.zeros(6, jnp.int32),
                       "c": jnp.zeros((), jnp.bfloat16)}}
    got, step = JManager(str(tmp_path)).restore(like)
    assert step == 4
    np.testing.assert_array_equal(np.asarray(got["a"]), tree["a"].numpy())
    np.testing.assert_array_equal(np.asarray(got["nested"]["b"]),
                                  tree["nested"]["b"].numpy())
    assert got["nested"]["c"].dtype == jnp.bfloat16
    assert float(got["nested"]["c"]) == 1.0


def test_port_manager_reads_what_the_reference_wrote(tmp_path):
    rng = np.random.default_rng(0)
    a = rng.standard_normal((5, 3)).astype(np.float32)
    c = rng.standard_normal(4).astype(ml_dtypes.bfloat16)
    JManager(str(tmp_path)).save(
        2, {"a": jnp.asarray(a), "nested": {"b": jnp.arange(6, dtype=jnp.int32),
                                            "c": jnp.asarray(c)}})
    got, step = CheckpointManager(str(tmp_path)).restore(_tree_())
    assert step == 2
    np.testing.assert_array_equal(got["a"].numpy(), a)
    np.testing.assert_array_equal(got["nested"]["b"].numpy(), np.arange(6))
    assert got["nested"]["c"].dtype == torch.bfloat16
    np.testing.assert_array_equal(got["nested"]["c"].float().numpy(),
                                  c.astype(np.float32))
