"""The port's training round trip against the JAX reference, on the CPU:

  * AdamW (``adamw_update`` with and without clipping, the 1-D leaves that
    skip weight decay, a scheduled lr), ``global_norm``,
    ``clip_by_global_norm``, ``warmup_cosine`` and the int8 quantizer on
    seeded trees;
  * the straggler watchdog flags the same steps, and its abort policy raises;
  * checkpoints cross packages: a ``CheckpointManager`` directory written by
    either package restores in the other with equal arrays (bf16 included)
    and manifest; keep-N GC and the ``.partial`` rule match; an async
    save's error surfaces on ``wait()``; ``restore(abstract=)`` refuses a
    mismatched leaf;
  * cross-framework resume: the reference's ``Trainer`` runs k steps of a
    reduced config and commits; the port's ``Trainer`` resumes that
    directory to 2k beside the reference resuming a copy; the losses per
    step and the final params agree within ``RESUME_TOL``;
  * the port's own checks, as tests/test_training_ft.py holds the
    reference: a preempted run resumes bit for bit, ``micro_batches=2``
    equals 1, the loss falls;
  * ``TRAINING_PROFILE``'s plan and entry names equal the reference's for
    every arch;
  * a trained checkpoint through FaaSLight: file elimination drops the
    optimizer and data state, before > after1 = after2 bytes read (tier-1
    is empty for the tied xLSTM), and the restored after2 server's tokens
    equal an engine's on the trainer's in-memory params;
  * the training launcher resumes across two invocations, as the
    reference's does."""

import json
import os
import re
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from jax.experimental.shard_map import shard_map
from jax.sharding import Mesh
from jax.sharding import PartitionSpec as P
from torch.distributed.device_mesh import init_device_mesh

from repro.checkpoint import CheckpointManager as RefManager
from repro.configs import ARCH_IDS
from repro.configs import get_reduced as ref_get_reduced
from repro.core import analyze as ref_analyze
from repro.core import recognize_entries as ref_recognize
from repro.core.entrypoints import TRAINING_PROFILE as REF_TRAINING
from repro.data import DataConfig as RefDataConfig
from repro.data import SyntheticTokenPipeline as RefPipeline
from repro.models.zoo import build_model as ref_build_model
from repro.optim import AdamWConfig as RefAdamWConfig
from repro.optim import AdamWState as RefAdamWState
from repro.optim import EFState as RefEFState
from repro.optim import adamw_update as ref_adamw_update
from repro.optim import clip_by_global_norm as ref_clip
from repro.optim import compressed_psum as ref_compressed_psum
from repro.optim import dequantize_int8 as ref_dequantize
from repro.optim import global_norm as ref_global_norm
from repro.optim import quantize_int8 as ref_quantize
from repro.optim import warmup_cosine as ref_warmup_cosine
from repro.training import StragglerWatchdog as RefWatchdog
from repro.training import TrainConfig as RefTrainConfig
from repro.training import Trainer as RefTrainer
from repro.utils.tree import flatten_with_paths as ref_flatten
from repro_torch.checkpoint import CheckpointManager
from repro_torch.checkpoint import manager as manager_mod
from repro_torch.configs import get_reduced
from repro_torch.core import (
    SERVING_PROFILE,
    TRAINING_PROFILE,
    analyze,
    build_artifact,
    recognize_entries,
    write_monolithic,
)
from repro_torch.data import DataConfig, SyntheticTokenPipeline
from repro_torch.models import build_model
from repro_torch.launch.mesh import world_size
from repro_torch.optim import (
    AdamWConfig,
    AdamWState,
    EFState,
    abstract_adamw,
    adamw_update,
    clip_by_global_norm,
    compressed_psum,
    dequantize_int8,
    global_norm,
    init_adamw,
    init_error_feedback,
    quantize_int8,
    warmup_cosine,
)
from repro_torch.serving import ColdStartReport, ColdStartServer, GenerationEngine, cold_start
from repro_torch.sharding import use_mesh
from repro_torch.training import StragglerWatchdog, TrainConfig, Trainer, make_train_step, value_and_grad
from repro_torch.utils.tree import flatten_with_paths, tree_map

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EPS = float(np.finfo(np.float32).eps)
# one optimizer update on fp32 inputs: the two frameworks' pow / sqrt /
# reduction orders differ by a few ulps of O(1) values
OPT_TOL = 64 * EPS
# two further training steps after a resume, at fp32 compute: each loss and
# gradient carries the models' O(10)-ulp reduction differences, which
# AdamW's m / sqrt(v) passes on to the update at about the same relative
# size (v is already warm at step k). Observed: losses within 8e-8
# relative; params and moments within 7e-8 for Phi-3 and Yi and 3.4e-6 for
# xLSTM (its exp-gated recurrences amplify the rounding). 1e-5 keeps a 3x
# margin over the largest and still catches a wrong update rule, whose
# steps move params by lr = 1e-3
RESUME_TOL = 1e-5


def _tree(seed):
    rs = np.random.default_rng(seed)
    return {"a": {"w": rs.standard_normal((4, 6)).astype(np.float32),
                  "b": rs.standard_normal(6).astype(np.float32)},
            "c": rs.standard_normal((3, 2, 2)).astype(np.float32),
            "scale": (1.0 + 0.1 * rs.standard_normal(5)).astype(np.float32)}


def _to_torch(tree):
    return tree_map(lambda a: torch.from_numpy(np.array(a)), tree)


def _to_jax(tree):
    return tree_map(jnp.asarray, tree)


def _assert_tree_close(got, want, tol, what=""):
    want = dict(ref_flatten(want))
    for p, t in flatten_with_paths(got):
        np.testing.assert_allclose(t.numpy(), np.asarray(want[p]), atol=tol, rtol=tol, err_msg=f"{what} {p}")


@pytest.mark.parametrize("case", ["clipped", "unclipped", "scheduled_lr"])
def test_adamw_update_matches_reference(case):
    """One update from step 3 with warm moments; weight decay skips the 1-D
    leaves (``b``, ``scale``)."""
    params, grads, m = _tree(0), tree_map(lambda a: 3.0 * a, _tree(1)), _tree(2)
    v = tree_map(lambda a: np.abs(a) + 0.01, _tree(3))
    kw = {"clip_norm": 0.0} if case == "unclipped" else {}
    step = np.int32(3)
    ref_lr = ref_warmup_cosine(1e-3, 2, 10)(jnp.asarray(step)) if case == "scheduled_lr" else None
    lr = warmup_cosine(1e-3, 2, 10)(torch.tensor(3, dtype=torch.int32)) if case == "scheduled_lr" else None
    ref_p, ref_s = ref_adamw_update(RefAdamWConfig(lr=1e-2, **kw), _to_jax(grads),
                                    RefAdamWState(jnp.asarray(step), _to_jax(m), _to_jax(v)), _to_jax(params), lr=ref_lr)
    p, s = adamw_update(AdamWConfig(lr=1e-2, **kw), _to_torch(grads),
                        AdamWState(torch.tensor(step), _to_torch(m), _to_torch(v)), _to_torch(params), lr=lr)
    assert int(s.step) == int(ref_s.step) == 4 and s.step.dtype == torch.int32
    _assert_tree_close(p, ref_p, OPT_TOL, "params")
    _assert_tree_close(s.m, ref_s.m, OPT_TOL, "m")
    _assert_tree_close(s.v, ref_s.v, OPT_TOL, "v")
    # decay reaches only the matrices: with zero grads a 1-D leaf does not move
    zero = tree_map(torch.zeros_like, _to_torch(grads))
    p0, _ = adamw_update(AdamWConfig(lr=1e-2, **kw), zero, AdamWState(torch.tensor(step), tree_map(torch.zeros_like, zero),
                                                                       tree_map(torch.zeros_like, zero)), _to_torch(params))
    assert torch.equal(p0["a"]["b"], _to_torch(params)["a"]["b"])
    assert not torch.equal(p0["a"]["w"], _to_torch(params)["a"]["w"])


def test_norm_clip_schedule_and_abstract_state_match_reference():
    grads = tree_map(lambda a: 3.0 * a, _tree(4))
    np.testing.assert_allclose(global_norm(_to_torch(grads)).numpy(), np.asarray(ref_global_norm(_to_jax(grads))),
                               rtol=OPT_TOL)
    for max_norm in (1.0, 100.0):  # clipping, and a norm already below the bound
        got, norm = clip_by_global_norm(_to_torch(grads), max_norm)
        want, ref_norm = ref_clip(_to_jax(grads), max_norm)
        np.testing.assert_allclose(norm.numpy(), np.asarray(ref_norm), rtol=OPT_TOL)
        _assert_tree_close(got, want, OPT_TOL, f"clip {max_norm}")
    for args in ((3e-4, 10, 100), (1e-3, 0, 7), (1e-3, 5, 5)):
        sched, ref_sched = warmup_cosine(*args), ref_warmup_cosine(*args)
        for step in range(0, args[2] + 3):
            got = sched(torch.tensor(step, dtype=torch.int32))
            assert got.dtype == torch.float32
            np.testing.assert_allclose(got.numpy(), np.asarray(ref_sched(jnp.int32(step))), rtol=4 * EPS,
                                       err_msg=f"{args} step {step}")
    abstract = abstract_adamw(build_model(get_reduced("yi-34b")).abstract())
    assert abstract.step.shape == () and abstract.step.dtype == torch.int32
    assert all(t.dtype == torch.float32 and t.device.type == "meta" for _, t in flatten_with_paths(abstract.m))


def test_int8_quantizer_matches_reference_exactly():
    """Payload and scale bit for bit (ties round to even in both), the
    dequantized values too; ``compressed_psum`` without an axis is the exact
    pass-through, and over a one-rank ``pod`` dim (a world of one) its mean
    and residual equal the reference's under ``shard_map`` on one device, bit
    for bit (tests/test_torch_pipeline.py holds four ranks)."""
    rs = np.random.default_rng(6)
    for g in (rs.standard_normal((7, 9)).astype(np.float32), np.array([0.5, -1.5, 2.5, 127.0], np.float32),
              np.zeros(4, np.float32)):
        q, scale = quantize_int8(torch.from_numpy(g))
        ref_q, ref_scale = ref_quantize(jnp.asarray(g))
        assert q.dtype == torch.int8
        np.testing.assert_array_equal(q.numpy(), np.asarray(ref_q))
        np.testing.assert_array_equal(scale.numpy(), np.asarray(ref_scale))
        np.testing.assert_array_equal(dequantize_int8(q, scale).numpy(), np.asarray(ref_dequantize(ref_q, ref_scale)))
    grads = _to_torch(_tree(7))
    ef = init_error_feedback(grads)
    out, ef2 = compressed_psum(grads, ef, None)
    assert ef2 is ef and all(torch.equal(a, b) for (_, a), (_, b) in zip(flatten_with_paths(out),
                                                                        flatten_with_paths(grads)))
    with pytest.raises(ValueError, match="DeviceMesh"):
        compressed_psum(grads, ef, "pod")  # an axis needs a mesh
    residual = tree_map(lambda a: (0.01 * a).astype(np.float32), _tree(8))
    ref_fn = shard_map(lambda g, r: ref_compressed_psum(g, RefEFState(r), "pod"),
                       mesh=Mesh(np.array(jax.devices()[:1]), ("pod",)), in_specs=(P(), P()),
                       out_specs=(P(), RefEFState(P())), check_rep=False)
    ref_avg, ref_ef = ref_fn(_to_jax(_tree(7)), _to_jax(residual))
    try:
        assert world_size("cpu", 1) == 1
        with use_mesh(init_device_mesh("cpu", (1,), mesh_dim_names=("pod",))):
            avg, ef2 = compressed_psum(grads, EFState(_to_torch(residual)), "pod")
    finally:
        torch.distributed.destroy_process_group()
    for got, want in ((avg, ref_avg), (ef2.residual, ref_ef.residual)):
        want = dict(ref_flatten(want))
        for p, t in flatten_with_paths(got):
            np.testing.assert_array_equal(t.numpy(), np.asarray(want[p]), err_msg=p)


def test_watchdog_flags_the_reference_steps_and_aborts():
    dts = [0.1 + 0.001 * (i % 3) for i in range(20)] + [1.5, 0.1, 0.102, 0.9, 0.1]
    mine, ref = StragglerWatchdog(z_threshold=3.0, warmup_steps=3), RefWatchdog(z_threshold=3.0, warmup_steps=3)
    assert [mine.record(i, dt) for i, dt in enumerate(dts)] == [ref.record(i, dt) for i, dt in enumerate(dts)]
    assert mine.flagged == ref.flagged and [f[0] for f in mine.flagged] == [20, 23]
    assert mine.mean_step_s == ref.mean_step_s
    for wd in (StragglerWatchdog(z_threshold=3.0, warmup_steps=2, policy="abort"),
               RefWatchdog(z_threshold=3.0, warmup_steps=2, policy="abort")):
        for i in range(10):
            wd.record(i, 0.1)
        with pytest.raises(RuntimeError, match="straggler"):
            wd.record(10, 5.0)


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------


def _collections(seed):
    rs = np.random.default_rng(seed)
    return {
        "params": {"w": rs.standard_normal((3, 4)).astype(np.float32),
                   "e": rs.standard_normal((5, 2)).astype(ml_dtypes.bfloat16)},
        "opt_state": {"step": np.int32(7), "m": {"w": rs.standard_normal((3, 4)).astype(np.float32)}},
        "data_state": {"step": np.int32(7)},
    }


def _np(t: torch.Tensor) -> np.ndarray:
    return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16) if t.dtype == torch.bfloat16 else t.numpy()


def _from_np(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_checkpoints_restore_across_packages(tmp_path, writer):
    """Steps 1..4 saved with keep_n 2 (the last one async) by one package
    restore in the other: the manifest, the kept step directories and every
    array (dtype included) are equal."""
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    if writer == "reference":
        mgr, other = RefManager(a, keep_n=2), CheckpointManager(a, keep_n=2)
        for s in (1, 2, 3, 4):
            mgr.save(s, tree_map(jnp.asarray, _collections(s)), blocking=s < 4)
    else:
        mgr, other = CheckpointManager(a, keep_n=2), RefManager(a, keep_n=2)
        for s in (1, 2, 3, 4):
            mgr.save(s, tree_map(_from_np, _collections(s)), blocking=s < 4)
    mgr.wait()
    assert other.all_steps() == mgr.all_steps() == [3, 4] and other.latest_step() == 4
    assert sorted(os.listdir(a)) == ["manifest.json", "step_00000003", "step_00000004"]
    for step in (3, 4):
        got = other.restore(step)
        assert got.step == step
        want = _collections(step)
        got_flat = dict(ref_flatten(got.collections) if writer == "port" else flatten_with_paths(got.collections))
        for path, arr in ref_flatten(want):
            g = np.asarray(got_flat[path]) if writer == "port" else _np(got_flat[path])
            arr = np.ascontiguousarray(arr)  # both store a 0-d step with shape [1]
            assert g.dtype == arr.dtype and g.shape == arr.shape, path
            np.testing.assert_array_equal(g, arr, err_msg=path)
    # the same saves from the other package give the same manifest and files
    mgr_b = CheckpointManager(b, keep_n=2) if writer == "reference" else RefManager(b, keep_n=2)
    conv = _from_np if writer == "reference" else jnp.asarray
    for s in (1, 2, 3, 4):
        mgr_b.save(s, tree_map(conv, _collections(s)), blocking=True)
    with open(os.path.join(a, "manifest.json")) as f1, open(os.path.join(b, "manifest.json")) as f2:
        assert json.load(f1) == json.load(f2)
    for name in ("params", "opt_state", "data_state"):
        for suffix in (".bin", ".index.json"):
            with open(os.path.join(a, "step_00000004", name + suffix), "rb") as f1, \
                    open(os.path.join(b, "step_00000004", name + suffix), "rb") as f2:
                assert f1.read() == f2.read(), name + suffix


def test_partial_dirs_are_never_listed_and_restore_validates(tmp_path, monkeypatch):
    """A stale ``.partial`` step is never listed or restored, in either
    package; ``restore(abstract=)`` refuses a wrong shape, dtype or missing
    leaf; an async save's error surfaces on the next ``wait()``."""
    mgr = CheckpointManager(str(tmp_path), keep_n=3)
    mgr.save(4, {"params": {"w": torch.arange(4.0)}}, blocking=True)
    (tmp_path / "step_00000099.partial").mkdir()
    for m in (mgr, RefManager(str(tmp_path))):
        assert m.all_steps() == [4] and m.restore().step == 4
    good = {"params": {"w": torch.empty(4, device="meta")}}
    assert mgr.restore(abstract=good).step == 4
    for bad, msg in (({"params": {"w": torch.empty(5, device="meta")}}, "shape"),
                     ({"params": {"w": torch.empty(4, dtype=torch.bfloat16, device="meta")}}, "dtype"),
                     ({"params": {"x": torch.empty(4, device="meta")}}, "missing leaf"),
                     ({"opt_state": {"w": torch.empty(4, device="meta")}}, "missing collection")):
        with pytest.raises(ValueError, match=msg):
            mgr.restore(abstract=bad)
    assert CheckpointManager(str(tmp_path / "empty")).restore() is None

    def broken(*args, **kwargs):
        raise OSError("disk full")

    monkeypatch.setattr(manager_mod.tsl, "write_bundle", broken)
    mgr.save(5, {"params": {"w": torch.arange(4.0)}}, blocking=False)
    with pytest.raises(RuntimeError, match="async checkpoint save failed"):
        mgr.wait()
    assert mgr.all_steps() == [4]
    mgr.wait()  # the error is raised once


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------


def _tc(cls, adamw_cls, **kw):
    base = dict(num_steps=12, save_every=4, adamw=adamw_cls(lr=1e-3))
    base.update(kw)
    return cls(**base)


@pytest.mark.parametrize("arch", ["phi3-medium-14b", "yi-34b", "xlstm-125m"])
def test_port_resumes_the_references_checkpoint(tmp_path, arch):
    """The reference trains k = 2 steps (fp32 compute, S = 32: xLSTM's
    prefill takes the chunkwise mLSTM) and commits; the port resumes that
    directory to 2k while the reference resumes a copy. Losses per resumed
    step and the final params, moments and data cursor agree within
    ``RESUME_TOL``, and the reference restores the port's final checkpoint."""
    k = 2
    ref_model = ref_build_model(ref_get_reduced(arch).replace(dtype="float32"))
    model = build_model(get_reduced(arch).replace(dtype="float32"))
    ref_data = RefPipeline(RefDataConfig(ref_model.cfg.vocab_size, 32, 4, seed=1))
    data = SyntheticTokenPipeline(DataConfig(model.cfg.vocab_size, 32, 4, seed=1))
    ref_tc = _tc(RefTrainConfig, RefAdamWConfig, num_steps=2 * k, save_every=k, warmup_steps=1)
    tc = _tc(TrainConfig, AdamWConfig, num_steps=2 * k, save_every=k, warmup_steps=1)
    RefTrainer(ref_model, ref_tc, ref_data, str(tmp_path / "port")).run(k)
    shutil.copytree(tmp_path / "port", tmp_path / "ref")
    ref = RefTrainer(ref_model, ref_tc, ref_data, str(tmp_path / "ref")).run()
    mine = Trainer(model, tc, data, str(tmp_path / "port"), device="cpu").run()
    assert mine.restored_from == ref.restored_from == k and mine.final_step == 2 * k
    np.testing.assert_allclose(mine.losses, ref.losses, rtol=RESUME_TOL)
    assert mine.losses[-1] != mine.losses[0]
    got = RefManager(str(tmp_path / "port")).restore()  # the port's checkpoint, read by the reference
    want = RefManager(str(tmp_path / "ref")).restore()
    assert got.step == want.step == 2 * k
    assert set(got.collections) == set(want.collections) == {"params", "opt_state", "data_state"}
    got_flat, want_flat = dict(ref_flatten(got.collections)), dict(ref_flatten(want.collections))
    assert list(got_flat) == list(want_flat)
    for p, a in want_flat.items():
        assert got_flat[p].dtype == a.dtype, p
        if p.endswith("step"):
            assert got_flat[p].shape == a.shape == (1,) and int(got_flat[p][0]) == int(a[0]) == 2 * k, p
        else:
            np.testing.assert_allclose(got_flat[p], a, atol=RESUME_TOL, rtol=RESUME_TOL, err_msg=p)


def test_preempted_run_resumes_bit_for_bit(tmp_path):
    """Preempted at 4 and resumed to 8 by a fresh Trainer, against a run
    straight to 8: every param, moment and cursor equal (bf16 compute, the
    config's)."""
    model = build_model(get_reduced("yi-34b"))
    data = SyntheticTokenPipeline(DataConfig(model.cfg.vocab_size, 32, 4, seed=1))
    tc = _tc(TrainConfig, AdamWConfig, num_steps=8)
    Trainer(model, tc, data, str(tmp_path / "a"), device="cpu").run(4)
    resumed = Trainer(model, tc, data, str(tmp_path / "a"), device="cpu")
    assert resumed.run().restored_from == 4
    straight = Trainer(model, tc, data, str(tmp_path / "b"), device="cpu")
    straight.run()
    fa = dict(flatten_with_paths(resumed.mgr.restore().collections))
    fb = dict(flatten_with_paths(straight.mgr.restore().collections))
    assert list(fa) == list(fb)
    for p in fa:
        assert torch.equal(fa[p], fb[p]), p
    for (p, a), (_, b) in zip(flatten_with_paths(resumed.params), flatten_with_paths(straight.params)):
        assert torch.equal(a, b), p


def test_microbatch_equivalence():
    """One step over 4 rows as 1, 2 and 4 micro-batches (no clipping): the
    same loss and params within fp32 accumulation error (the reference's
    test's bounds)."""
    model = build_model(get_reduced("phi3-medium-14b"))
    gen = torch.Generator().manual_seed(0)
    p = model.init(gen, device="cpu", dtype=torch.float32)
    batch = {"tokens": torch.randint(0, model.cfg.vocab_size, (4, 16), generator=gen),
             "labels": torch.randint(0, model.cfg.vocab_size, (4, 16), generator=gen)}
    outs = []
    for n in (1, 2, 4):
        tc = TrainConfig(num_steps=10, micro_batches=n, adamw=AdamWConfig(lr=1e-3, clip_norm=0.0))
        p1, opt, m = make_train_step(model, tc)(p, init_adamw(p), batch)
        assert int(opt.step) == 1 and m["loss"].dtype == torch.float32
        outs.append((p1, float(m["loss"])))
    for p1, loss in outs[1:]:
        assert abs(loss - outs[0][1]) < 1e-5
        for (k, a), (_, b) in zip(flatten_with_paths(outs[0][0]), flatten_with_paths(p1)):
            np.testing.assert_allclose(a.numpy(), b.numpy(), atol=2e-5, err_msg=k)


def test_loss_decreases(tmp_path):
    model = build_model(get_reduced("phi3-medium-14b"))
    data = SyntheticTokenPipeline(DataConfig(model.cfg.vocab_size, 32, 4, seed=1))
    r = Trainer(model, _tc(TrainConfig, AdamWConfig), data, str(tmp_path), device="cpu").run()
    assert len(r.losses) == 12 and r.losses[-1] < r.losses[0]


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_training_profile_plan_matches_reference(arch):
    """Entry names (modal families: the multimodal train step and its
    text-only twin) and the whole plan summary under ``TRAINING_PROFILE``."""
    ref_model, model = ref_build_model(ref_get_reduced(arch)), build_model(get_reduced(arch))
    assert [e.name for e in recognize_entries(model, TRAINING_PROFILE, B=1, S=32)] == \
        [e.name for e in ref_recognize(ref_model, REF_TRAINING, B=1, S=32)]
    assert analyze(model, TRAINING_PROFILE, trace_S=32).summary() == \
        ref_analyze(ref_model, REF_TRAINING, trace_S=32).summary()


def test_trained_checkpoint_serves_through_faaslight(tmp_path):
    """Train reduced xLSTM 3 steps, restore the committed step, analyze it
    for serving (file elimination drops ``opt_state`` and ``data_state``),
    write before / after1 / after2 and cold-start each: before reads more
    than after1, which reads what after2 does (tier-1 is empty); the after2
    server's tokens equal an engine's on the trainer's in-memory params."""
    model = build_model(get_reduced("xlstm-125m"))
    data = SyntheticTokenPipeline(DataConfig(model.cfg.vocab_size, 32, 2, seed=3))
    trainer = Trainer(model, TrainConfig(num_steps=3, save_every=3, warmup_steps=1), data, str(tmp_path / "ck"),
                      device="cpu")
    trainer.run()
    restored = trainer.mgr.restore()
    result = analyze(model, SERVING_PROFILE, collections=restored.collections, trace_S=32)
    nbytes = {c: sum(t.numel() * t.element_size() for _, t in flatten_with_paths(restored.collections[c]))
              for c in restored.collections}
    assert result.summary()["dropped_collections_bytes"] == nbytes["opt_state"] + nbytes["data_state"]
    assert result.plan.summary()["tier1_leaves"] == 0
    outdir = str(tmp_path / "art")
    build_artifact(restored.collections["params"], result, outdir)
    for pruned in (False, True):
        write_monolithic(restored.collections, outdir, pruned=pruned)
    prompt = torch.randint(0, model.cfg.vocab_size, (2, 16), generator=torch.Generator().manual_seed(1))
    read = {}
    for mode in ("before", "after1", "after2"):
        with cold_start(model, outdir, result, mode=mode, residency="strict" if mode == "after2" else None,
                        compile_warm_set=False, device="cpu") as server:
            read[mode] = server.report.bytes_read
            tokens, stats = GenerationEngine(server, max_seq=32).generate(prompt, 3)
            assert stats.faulted_units == 0
    assert read["before"] > read["after1"] == read["after2"] == nbytes["params"]
    memory = ColdStartServer(model, trainer.params, ColdStartReport(mode="before"), device="cpu")
    want, _ = GenerationEngine(memory, max_seq=32).generate(prompt, 3)
    np.testing.assert_array_equal(tokens, want)


def _launch(module, *argv, cwd):
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"), JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, "-m", module, *argv], cwd=cwd, env=env, capture_output=True, text=True,
                          timeout=300)


def test_training_launcher_resumes_across_invocations(tmp_path):
    """Two invocations (2 steps, then to 4) of each package's launcher under
    ``checkpoints/<config name>`` in the working directory: both print the
    ``[train]`` lines, the second resumes from step 2, and each package's
    own restore reads step 4 with the reference's collections."""
    argv = ["--arch", "yi-34b", "--reduced", "--seq", "16", "--batch", "2", "--save-every", "2"]
    pattern = r"^\[train\] done @ step (\d+); loss [\d.]+ -> [\d.]+; resumed_from=(\w+); stragglers=\d+$"
    for module, extra in (("repro_torch.launch.train", ["--device", "cpu"]), ("repro.launch.train", [])):
        cwd = tmp_path / module
        cwd.mkdir()
        done = []
        for steps in ("2", "4"):
            res = _launch(module, *argv, "--steps", steps, *extra, cwd=str(cwd))
            assert res.returncode == 0, res.stderr
            assert re.search(r"^\[train\] yi-34b-reduced: [\d,]+ params \([\d,]+ active\) on ", res.stdout, re.M)
            done.append(re.search(pattern, res.stdout, re.M).groups())
        assert done == [("2", "None"), ("4", "2")]
        ckpt = str(cwd / "checkpoints" / "yi-34b-reduced")
        assert CheckpointManager(ckpt).all_steps() == RefManager(ckpt).all_steps() == [2, 4]
        assert set(CheckpointManager(ckpt).restore().collections) == {"params", "opt_state", "data_state"}


@pytest.mark.parametrize("arch", ["mixtral-8x22b", "recurrentgemma-9b"])
def test_the_loss_names_the_plain_versions_and_serving_the_wrappers(monkeypatch, arch):
    """Routing by caller: a prefill reaches the kernels' wrappers through the
    attention and recurrent modules' names (so a patch of those names, as
    chip_smoke's plain runs make, takes effect), and the loss reaches only
    the plain versions, whatever those names hold."""
    from repro_torch.models import attention as attn_mod
    from repro_torch.models import recurrent as rec_mod

    calls = []

    def spy(name, fn):
        def wrapped(*args, **kwargs):
            calls.append(name)
            return fn(*args, **kwargs)
        return wrapped

    monkeypatch.setattr(attn_mod, "flash_attention", spy("flash", attn_mod.flash_attention))
    monkeypatch.setattr(rec_mod, "rglru_scan", spy("scan", rec_mod.rglru_scan))
    model = build_model(get_reduced(arch).replace(num_layers=3))
    params = model.init(torch.Generator().manual_seed(0), device="cpu", dtype=torch.float32)
    tokens = torch.randint(0, model.cfg.vocab_size, (2, 8), generator=torch.Generator().manual_seed(1))
    model.prefill(params, {"tokens": tokens})
    kinds = model.cfg.attn_kinds
    assert sorted(calls) == sorted(["flash" if k != "rec" else "scan" for k in kinds])
    calls.clear()
    loss, grads = value_and_grad(model.loss_fn, params, {"tokens": tokens, "labels": tokens})
    assert calls == [] and torch.isfinite(loss)
    assert all(torch.isfinite(g).all() for _, g in flatten_with_paths(grads))
