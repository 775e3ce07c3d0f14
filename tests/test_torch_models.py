"""Model parity of the PyTorch port against the JAX reference: configs field
for field, parameter paths and shapes (reduced, and at full width for
RecurrentGemma, Gemma-3, DeepSeek-V2-Lite, Whisper, Llama-3.2-Vision and
xLSTM),
and — on reference weights carried over by ``convert.params_from_numpy`` —
prefill logits, caches and MoE usage masks, then decode steps across the
sliding window (Gemma-3's rolling local caches and its unwindowed global
layer, DeepSeek's latent MLA caches, xLSTM's fp32 recurrent state, the
modal families text-only), at
float32 on CPU. The modal families' multimodal paths are held in
tests/test_torch_encdec.py and tests/test_torch_vlm.py."""

import dataclasses
import gc
import weakref

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS
from repro.configs import get_config as ref_get_config
from repro.configs import get_reduced as ref_get_reduced
from repro.models.zoo import build_model as ref_build_model
from repro.serving.engine import _graft_prefill_cache as ref_graft
from repro.serving.engine import _strip_usage as ref_strip
from repro.utils.tree import flatten_with_paths as ref_flatten
from repro_torch.configs import get_config, get_reduced
from repro_torch.convert import params_from_numpy, tensor_from_numpy
from repro_torch.models import build_model
from repro_torch.serving.engine import _graft_prefill_cache, _strip_usage
from repro_torch.utils.tree import flatten_with_paths, tree_from_flat

PORTED = ["mixtral-8x22b", "yi-34b", "phi3-medium-14b", "mistral-large-123b", "recurrentgemma-9b",
          "gemma3-27b", "deepseek-v2-lite-16b", "whisper-base", "llama-3.2-vision-90b", "xlstm-125m"]
# depth of the parity runs where the reduced config's would skip a layout
# section: 5 RecurrentGemma layers are one (rec, rec, attn) group plus a
# (rec, rec) tail
PARITY_LAYERS = {"recurrentgemma-9b": 5}
# prompt length of the decode parity runs (default 28): reduced Gemma-3's
# prompt must fit its 16-token local window (the prefill graft of both
# packages needs it), and its decode then crosses position 16; reduced
# xLSTM's 32 is two chunks of 16, so its prefill takes the chunkwise mLSTM
# (tests/test_torch_xlstm.py holds the scan prompt)
PARITY_PROMPT = {"gemma3-27b": 12, "xlstm-125m": 32}

# fp32 tolerance: each logit is a few layers of D=64..128-term dot products,
# so the two frameworks' reduction orders differ by O(10) ulps of O(1)
# values (observed ≤ 16·eps on logits and caches); 256·eps ≈ 3e-5 leaves
# a >10x margin while still catching any real numerical divergence.
EPS = float(np.finfo(np.float32).eps)
TOL = 256 * EPS


def _reference(arch):
    cfg = ref_get_reduced(arch).replace(dtype="float32", collect_moe_usage=True)
    cfg = cfg.replace(num_layers=PARITY_LAYERS.get(arch, cfg.num_layers))
    model = ref_build_model(cfg)
    params = model.init(jax.random.PRNGKey(0))
    return model, params, {p: np.asarray(v) for p, v in ref_flatten(params)}


def _port(arch, flat):
    cfg = get_reduced(arch).replace(dtype="float32", collect_moe_usage=True)
    cfg = cfg.replace(num_layers=PARITY_LAYERS.get(arch, cfg.num_layers))
    return build_model(cfg), params_from_numpy(flat, "cpu")


def _assert_trees_match(ref_tree, port_tree):
    ref_flat, port_flat = dict(ref_flatten(ref_tree)), dict(flatten_with_paths(port_tree))
    assert list(ref_flat) == list(port_flat)
    for path, ref in ref_flat.items():
        ref, got = np.asarray(ref), port_flat[path].numpy()
        assert got.shape == ref.shape, path
        if ref.dtype == bool:
            np.testing.assert_array_equal(got, ref, err_msg=path)  # usage masks: exact
        else:
            np.testing.assert_allclose(got, ref, atol=TOL, rtol=TOL, err_msg=path)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_configs_equal_reference(arch):
    for mine, ref in ((get_config(arch), ref_get_config(arch)), (get_reduced(arch), ref_get_reduced(arch))):
        assert dataclasses.asdict(mine) == dataclasses.asdict(ref)


@pytest.mark.parametrize("arch", PORTED)
def test_param_paths_and_shapes_equal_reference(arch):
    ref = ref_build_model(ref_get_reduced(arch)).abstract()
    mine = build_model(get_reduced(arch)).abstract()
    assert [(p, tuple(v.shape)) for p, v in ref_flatten(ref)] == \
        [(p, tuple(v.shape)) for p, v in flatten_with_paths(mine)]
    assert build_model(get_reduced(arch)).access() == ref_build_model(ref_get_reduced(arch)).access()


def test_full_depth_layout_equals_reference():
    """Full-size RecurrentGemma-9B (38 layers: 12 rec/rec/attn groups and a
    rec/rec tail) lays out the reference's paths, shapes and access."""
    arch = "recurrentgemma-9b"
    ref = ref_build_model(ref_get_config(arch))
    mine = build_model(get_config(arch), param_dtype=torch.bfloat16)
    assert (mine.layout.unit_kinds, mine.layout.n_groups, mine.layout.tail_kinds) == \
        (("rec", "rec", "attn"), 12, ("rec", "rec"))
    assert [(p, tuple(v.shape)) for p, v in ref_flatten(ref.abstract())] == \
        [(p, tuple(v.shape)) for p, v in flatten_with_paths(mine.abstract())]
    assert mine.access() == ref.access()
    assert sum(v.numel() for _, v in flatten_with_paths(mine.abstract())) == ref.num_params()
    assert [(p, tuple(c.shape)) for p, c in flatten_with_paths(mine.abstract_cache(2, 1048, multimodal=False))] == \
        [(p, tuple(c.shape)) for p, c in ref_flatten(ref.abstract_cache(2, 1048, multimodal=False))]


@pytest.mark.parametrize("arch,layout", [
    ("gemma3-27b", ((), ("local",) * 5 + ("global",), 10, ("local", "local"))),
    ("deepseek-v2-lite-16b", (("self",), ("self",), 26, ())),
    ("whisper-base", ((), ("self",), 6, ())),
    ("llama-3.2-vision-90b", ((), ("self",) * 4 + ("cross",), 20, ())),
    ("xlstm-125m", ((), ("m", "s"), 6, ())),
])
def test_full_width_layout_equals_reference(arch, layout):
    """Full-size Gemma-3 (62 layers: ten 5:1 units and a local/local tail),
    DeepSeek-V2-Lite (a dense lead layer and 26 MoE groups), Whisper (6
    decoder layers, 6 encoder layers), Llama-3.2-Vision (twenty 4-self:1-
    cross units) and xLSTM (six m/s units; 134,333,232 params) lay out the
    reference's paths, shapes, access and caches (shapes and dtypes),
    text-only and multimodal."""
    ref = ref_build_model(ref_get_config(arch))
    mine = build_model(get_config(arch), param_dtype=torch.bfloat16)
    lay = mine.layout
    assert (lay.lead_kinds, lay.unit_kinds, lay.n_groups, lay.tail_kinds) == layout
    assert [(p, tuple(v.shape)) for p, v in ref_flatten(ref.abstract())] == \
        [(p, tuple(v.shape)) for p, v in flatten_with_paths(mine.abstract())]
    assert mine.access() == ref.access()
    assert sum(v.numel() for _, v in flatten_with_paths(mine.abstract())) == ref.num_params()
    for mm in (False, True):
        assert [(p, tuple(c.shape), str(c.dtype).removeprefix("torch."))
                for p, c in flatten_with_paths(mine.abstract_cache(2, 1048, multimodal=mm))] \
            == [(p, tuple(c.shape), np.dtype(c.dtype).name)
                for p, c in ref_flatten(ref.abstract_cache(2, 1048, multimodal=mm))]


@pytest.mark.parametrize("arch", PORTED[:3] + ["recurrentgemma-9b", "gemma3-27b", "deepseek-v2-lite-16b",
                                  "whisper-base", "llama-3.2-vision-90b", "xlstm-125m"])
def test_prefill_and_decode_match_reference(arch):
    """Text-only prefill and decode (the served path of every family)."""
    ref_model, ref_params, flat = _reference(arch)
    model, params = _port(arch, flat)
    # decode crosses Mixtral's (and RecurrentGemma's) 32-token window, Gemma-3's 16-token one
    B, S, S_max, steps = 2, PARITY_PROMPT.get(arch, 28), 64, 6
    tokens = np.random.default_rng(7).integers(0, model.cfg.vocab_size, (B, S))

    ref_decode = jax.jit(ref_model.decode_step)
    ref_logits, ref_caches = jax.jit(ref_model.prefill)(ref_params, {"tokens": jnp.asarray(tokens, jnp.int32)})
    logits, caches = model.prefill(params, {"tokens": torch.from_numpy(tokens)})
    np.testing.assert_allclose(logits.numpy(), np.asarray(ref_logits), atol=TOL, rtol=TOL)
    _assert_trees_match(ref_caches, caches)
    if model.cfg.moe is not None:
        assert any(p.endswith("moe_usage") for p, _ in flatten_with_paths(caches))

    ref_caches = ref_graft(ref_model.init_cache(B, S_max, multimodal=False), ref_strip(ref_caches))
    caches = _graft_prefill_cache(model.init_cache(B, S_max, multimodal=False, device="cpu"), _strip_usage(caches))
    tok = np.argmax(np.asarray(ref_logits), -1)
    for step in range(steps):
        ref_logits, ref_caches = ref_decode(ref_params, ref_caches, {
            "tokens": jnp.asarray(tok[:, None], jnp.int32), "pos": jnp.full((B,), S + step, jnp.int32)})
        logits, caches = model.decode_step(params, caches, {
            "tokens": torch.from_numpy(tok[:, None]), "pos": torch.full((B,), S + step)})
        np.testing.assert_allclose(logits.numpy(), np.asarray(ref_logits), atol=TOL, rtol=TOL)
        _assert_trees_match(ref_caches, caches)
        ref_caches, caches = ref_strip(ref_caches), _strip_usage(caches)
        tok = np.argmax(np.asarray(ref_logits), -1)


@pytest.mark.parametrize("dtype", [np.float32, ml_dtypes.bfloat16, np.int32], ids=str)
def test_convert_round_trip(dtype):
    rs = np.random.default_rng(0)
    flat = {"a.b": rs.standard_normal((3, 4)).astype(dtype), "a.c": rs.standard_normal(5).astype(dtype),
            "d": rs.standard_normal((2, 2, 2)).astype(dtype)}
    tree = params_from_numpy(flat, "cpu")
    assert set(tree) == {"a", "d"} and set(tree["a"]) == {"b", "c"}
    for path, t in flatten_with_paths(tree):
        back = t.view(torch.int16).numpy().view(ml_dtypes.bfloat16) if t.dtype == torch.bfloat16 else t.numpy()
        np.testing.assert_array_equal(back, flat[path])
        assert back.dtype == flat[path].dtype
    assert tensor_from_numpy(flat["d"], "cpu").is_contiguous()


def test_tree_flatten_matches_reference_and_frees_leaves():
    tree = {"b": {"u1": torch.ones(2), "u0": {"z": torch.ones(1), "a": torch.ones(3)}}, "a": torch.zeros(1)}
    ref_tree = {"b": {"u1": np.ones(2), "u0": {"z": np.ones(1), "a": np.ones(3)}}, "a": np.zeros(1)}
    paths = [p for p, _ in flatten_with_paths(tree)]
    assert paths == [p for p, _ in ref_flatten(ref_tree)] == ["a", "b.u0.a", "b.u0.z", "b.u1"]
    assert [p for p, _ in flatten_with_paths(tree_from_flat(dict(flatten_with_paths(tree))))] == paths
    # flattening must not create reference cycles: a served model's weights
    # would otherwise outlive their last user until the cyclic GC runs
    leaf = weakref.ref(tree["b"]["u1"])
    gc.disable()
    try:
        flatten_with_paths(tree)
        del tree
        assert leaf() is None
    finally:
        gc.enable()
