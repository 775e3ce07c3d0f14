"""Model facade: one object per architecture binding config → params,
entries, caches, and FaaSLight metadata (``repro.models.zoo`` counterpart).

``Model.entries()`` is the Application Entry Recognition surface: each entry
is a function plus ``meta``-device example arguments, which the Program
Analyzer traces without allocating: ``train_step`` (the loss), ``prefill``
and ``decode_step``. A modal family (Whisper, the VLM) registers each entry
twice, a multimodal one and its ``_text_only`` twin, as the reference does;
a text-only deployment recognizes only the twins.

Under a mesh of more than one rank every family computes on shards
(``Model.prefill_sharded`` / ``decode_step_sharded``): the uniform GQA
stacks, dense or MoE (Mixtral, Yi, Phi-3, Mistral-Large), Gemma-3's 5:1
local/global stack, DeepSeek-V2-Lite's MLA, RecurrentGemma's RG-LRU hybrid,
xLSTM's mLSTM / sLSTM stack, Whisper's encoder-decoder and the VLM's gated
cross blocks, multimodal batches too, and so does the train step
(``Model.loss_fn_sharded``).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Optional

import torch

from repro_torch.configs.base import ModelConfig, ShapeSpec
from repro_torch.models import recurrent as rec_mod
from repro_torch.models import transformer as tf
from repro_torch.models import xlstm as xlstm_mod
from repro_torch.models.spec import abstract_params, access_annotations, init_params
from repro_torch.utils.tree import flatten_with_paths, tree_from_flat, tree_map

WHISPER_DECODE_ENC_LEN = 1500  # 30 s of audio: the encoder memory an audio decode attends to

# logical axes of the batch entries, as the reference's batch specs give them
_BATCH_AXES = {"tokens": ("batch", "seq"), "labels": ("batch", "seq"), "frames": ("batch", "seq", "embed"),
               "image_embeds": ("batch", None, None), "pos": ("batch",), "active": ("batch",)}


@dataclass(frozen=True)
class CacheLeaf:
    shape: tuple
    dtype: torch.dtype
    axes: tuple = ()


@dataclass(frozen=True)
class EntryPoint:
    """(name, fn, abstract args) — the FaaSLight 'serverless function'."""

    name: str
    fn: Callable  # fn(params, *args)
    args: tuple  # example argument trees on the meta device
    kind: str  # train | prefill | decode
    arg_axes: tuple = ()  # matching logical-axes trees (``Model.input_specs``)


class Model:
    """``param_dtype`` is the stored weights' dtype (default: the spec's
    float32, as the reference stores them); compute runs in ``cfg.dtype``."""

    def __init__(self, cfg: ModelConfig, *, param_dtype: Optional[torch.dtype] = None):
        cfg.validate()
        self.cfg = cfg
        self.param_dtype = param_dtype
        self.spec = tf.stack_spec(cfg)
        self.layout = tf.stack_layout(cfg)

    # -- params ------------------------------------------------------------
    def init(self, gen: torch.Generator, *, device="cuda", dtype=None, blocks: Optional[dict] = None) -> dict:
        """The params drawn from ``gen``; with ``blocks`` (path -> one slice a
        dim: a rank's block), only those blocks, holding the numbers the
        whole tree would (``spec.init_params``)."""
        return init_params(self.spec, gen, device=device,
                           dtype_override=dtype or self.param_dtype, blocks=blocks)

    def abstract(self, dtype=None) -> dict:
        return abstract_params(self.spec, dtype_override=dtype or self.param_dtype)

    def logical_axes(self) -> dict:
        """The param tree's shape with each leaf's logical axes tuple."""
        return tree_from_flat(self.axes())

    def access(self) -> dict[str, str]:
        return access_annotations(self.spec)

    def axes(self) -> dict[str, tuple]:
        """dotted-path -> logical axes tuple (ParamSpec.axes)."""
        return {p: s.axes for p, s in flatten_with_paths(self.spec)}

    def num_params(self) -> int:
        return sum(math.prod(s.shape) for _, s in flatten_with_paths(self.spec))

    def active_params(self) -> int:
        """Parameters touched per token (MoE experts scaled by top_k/E)."""
        access, m = self.access(), self.cfg.moe
        total = 0
        for path, s in flatten_with_paths(self.spec):
            n = math.prod(s.shape)
            if access[path] == "routed" and m is not None:
                n = int(n * m.top_k / m.num_experts)
            total += n
        return total

    # -- forward fns ---------------------------------------------------------
    def loss_fn(self, params, batch):
        return tf.loss_fn(self.cfg, params, batch)

    def prefill(self, params, batch):
        return tf.prefill(self.cfg, params, batch)

    def decode_step(self, params, caches, batch):
        return tf.decode_step(self.cfg, params, caches, batch)

    def decode_step_masked(self, params, caches, batch):
        """One decode step over a scheduler's slot batch; needs
        ``batch["active"]`` (B,) bool. ``active`` gates one thing, usage-mask
        collection (``moe_forward(usage_rows=...)``), so a free slot decoding
        a pad token never faults an expert in. Inactive rows otherwise compute
        values nobody reads: their logits are ignored and their cache rows are
        rebuilt at the slot's next admission (``scheduler._graft_slot_cache``)."""
        if "active" not in batch:
            raise ValueError("decode_step_masked needs batch['active'] (B,) bool")
        return tf.decode_step(self.cfg, params, caches, batch)

    def prefill_sharded(self, params, batch, comm):
        """``prefill`` on a rank's shards (``transformer.prefill_sharded``)."""
        return tf.prefill_sharded(self.cfg, params, batch, comm)

    def loss_fn_sharded(self, params, batch, comm):
        """This rank's share of ``loss_fn`` on its shards
        (``transformer.loss_fn_sharded``)."""
        return tf.loss_fn_sharded(self.cfg, params, batch, comm)

    def logits_table(self, params):
        """The head's table (the embedding, where the config ties them)."""
        return tf.logits_table(self.cfg, params)

    def decode_step_sharded(self, params, caches, batch, comm, cache_specs):
        """``decode_step`` on a rank's shards (``transformer.decode_step_sharded``)."""
        return tf.decode_step_sharded(self.cfg, params, caches, batch, comm, cache_specs)

    # -- caches --------------------------------------------------------------
    def _block_cache_template(self, kind: str, B: int, S_max: int, multimodal: bool) -> dict:
        """One block's cache leaves, each with the reference's logical axes."""
        leaves = self._block_cache_leaves(kind, B, S_max, multimodal)
        return {name: CacheLeaf(c.shape, c.dtype, tf.cache_leaf_axes(kind, name))
                for name, c in leaves.items()}

    def _block_cache_leaves(self, kind: str, B: int, S_max: int, multimodal: bool) -> dict:
        cfg = self.cfg
        dt = getattr(torch, cfg.dtype)
        Hkv, hd = cfg.num_kv_heads, cfg.resolved_head_dim
        if kind == "cross":  # the VLM's image block: cross K/V, for multimodal decode only
            if not multimodal:
                return {}
            leaf = CacheLeaf((B, cfg.vlm.num_image_tokens, Hkv, hd), dt)
            return {"xk": leaf, "xv": leaf}
        if kind == "rec":
            return {k: CacheLeaf(shape, dt) for k, shape in rec_mod.rglru_cache_shapes(cfg, B).items()}
        if kind == "m":  # the recurrent state is fp32, only the conv inputs in cfg.dtype
            return {k: CacheLeaf(shape, dt if k == "conv" else torch.float32)
                    for k, shape in xlstm_mod.mlstm_cache_shapes(cfg, B).items()}
        if kind == "s":
            return {k: CacheLeaf(shape, torch.float32) for k, shape in xlstm_mod.slstm_cache_shapes(cfg, B).items()}
        if cfg.mla is not None:  # the latent cache, every layer linear
            m = cfg.mla
            return {"ckv": CacheLeaf((B, S_max, m.kv_lora_rank), dt),
                    "kr": CacheLeaf((B, S_max, m.qk_rope_head_dim), dt)}
        window = tf._kind_window(cfg, kind)
        Skv = min(S_max, window) if window else S_max
        leaf = CacheLeaf((B, Skv, Hkv, hd), dt)
        out = {"k": leaf, "v": leaf}
        if cfg.encdec is not None and multimodal:
            # audio serving only: a text-only decode carries no cross state
            enc = CacheLeaf((B, WHISPER_DECODE_ENC_LEN, Hkv, hd), dt)
            out.update(xk=enc, xv=enc)
        return out

    def cache_template(self, B: int, S_max: int, *, multimodal: bool) -> dict:
        """Caches per block kind, in the params' lead / groups / tail sections
        (group leaves stacked on a leading axis). ``multimodal`` adds the
        cross K/V of a modal family; serving is text-only and passes False.
        It has no default, so no caller gets cross K/V it did not ask for."""
        lay = self.layout

        def section(kinds: tuple, prefix: str = "b") -> dict:
            return {f"{prefix}{i}": self._block_cache_template(k, B, S_max, multimodal) for i, k in enumerate(kinds)}

        tpl: dict = {}
        if lay.lead_kinds:
            tpl["lead"] = section(lay.lead_kinds)
        if lay.n_groups:
            tpl["groups"] = tree_map(lambda c: CacheLeaf((lay.n_groups,) + c.shape, c.dtype, ("layers",) + c.axes),
                                     section(lay.unit_kinds, "u"))
        if lay.tail_kinds:
            tpl["tail"] = section(lay.tail_kinds)
        return tpl

    def abstract_cache(self, B: int, S_max: int, *, multimodal: bool) -> dict:
        return tree_map(lambda c: torch.empty(c.shape, dtype=c.dtype, device="meta"),
                        self.cache_template(B, S_max, multimodal=multimodal))

    def cache_axes(self, B: int, S_max: int, *, multimodal: bool) -> dict:
        """The cache tree's shape with each leaf's logical axes tuple."""
        return tree_map(lambda c: c.axes, self.cache_template(B, S_max, multimodal=multimodal))

    def init_cache(self, B: int, S_max: int, *, multimodal: bool, device="cuda") -> dict:
        return tree_map(lambda c: torch.zeros(c.shape, dtype=c.dtype, device=device),
                        self.cache_template(B, S_max, multimodal=multimodal))

    # -- batches -------------------------------------------------------------
    def prefill_batch_spec(self, B: int, S: int, *, multimodal: bool) -> dict:
        """``tokens``, plus a multimodal batch's ``frames`` (encoder-decoder)
        or ``image_embeds`` (VLM). The reference adds ``frames`` to its
        text-only batches too and its callers pop it; here a text-only batch
        never holds it, so no text-only entry can trace the encoder."""
        cfg = self.cfg
        dt = getattr(torch, cfg.dtype)
        spec = {"tokens": torch.empty((B, S), dtype=torch.int64, device="meta")}
        if cfg.encdec is not None and multimodal:
            spec["frames"] = torch.empty((B, S, cfg.d_model), dtype=dt, device="meta")
        if cfg.vlm is not None and multimodal:
            spec["image_embeds"] = torch.empty((B, cfg.vlm.num_image_tokens, cfg.vlm.vision_dim), dtype=dt,
                                               device="meta")
        return spec

    def train_batch_spec(self, B: int, S: int, *, multimodal: bool) -> dict:
        """``prefill_batch_spec`` plus the next-token ``labels``."""
        return {**self.prefill_batch_spec(B, S, multimodal=multimodal),
                "labels": torch.empty((B, S), dtype=torch.int64, device="meta")}

    def decode_batch_spec(self, B: int) -> dict:
        return {
            "tokens": torch.empty((B, 1), dtype=torch.int64, device="meta"),
            "pos": torch.empty((B,), dtype=torch.int64, device="meta"),
        }

    def decode_masked_batch_spec(self, B: int) -> dict:
        """``decode_batch_spec`` plus the scheduler's per-slot active mask."""
        return {**self.decode_batch_spec(B), "active": torch.empty((B,), dtype=torch.bool, device="meta")}

    @staticmethod
    def batch_axes(batch_spec: dict, kind: str) -> dict:
        """The logical axes of each entry of a ``kind`` batch spec (the second
        half of the reference's ``*_batch_spec`` pairs)."""
        axes = dict(_BATCH_AXES, tokens=("batch", None)) if kind == "decode" else _BATCH_AXES
        return {k: axes[k] for k in batch_spec}

    def input_specs(self, shape: ShapeSpec, *, multimodal: bool = True) -> EntryPoint:
        """The single (arch × shape) dry-run cell entry, with its arguments'
        logical axes. Token ids and positions are int32 as in the
        reference's cell, and an encoder-decoder's train and prefill batches
        carry ``frames`` as the reference's do."""
        B, S = shape.global_batch, shape.seq_len

        def ids32(spec: dict) -> dict:
            return {k: torch.empty(v.shape, dtype=torch.int32, device="meta") if v.dtype == torch.int64 else v
                    for k, v in spec.items()}

        if shape.kind == "decode":
            cache = self.abstract_cache(B, S, multimodal=multimodal)
            batch = ids32(self.decode_batch_spec(B))
            return EntryPoint("decode_step", self.decode_step, (cache, batch), "decode",
                              (self.cache_axes(B, S, multimodal=multimodal), self.batch_axes(batch, "decode")))
        mm = multimodal or self.cfg.encdec is not None
        spec = self.train_batch_spec(B, S, multimodal=mm) if shape.kind == "train" else \
            self.prefill_batch_spec(B, S, multimodal=mm)
        if not multimodal:
            spec.pop("image_embeds", None)
        batch = ids32(spec)
        name, fn = ("train_step", self.loss_fn) if shape.kind == "train" else ("prefill", self.prefill)
        return EntryPoint(name, fn, (batch,), shape.kind, (self.batch_axes(batch, shape.kind),))

    # -- entry registry (Application Entry Recognition) ----------------------
    def entries(self, B: int = 1, S: int = 128) -> list[EntryPoint]:
        """Every entry at a given (B, S). A modal family registers both
        variants (what the analyzer needs), the multimodal ones first; each
        variant's train step, prefill and decode come in that order, as the
        reference orders them. The twins are named ``*_text_only``."""
        modal = self.cfg.vlm is not None or self.cfg.encdec is not None
        out = []
        for mm in ((True, False) if modal else (False,)):
            suffix = "_text_only" if modal and not mm else ""
            out.append(EntryPoint(f"train_step{suffix}", self.loss_fn,
                                  (self.train_batch_spec(B, S, multimodal=mm),), "train"))
            out.append(EntryPoint(f"prefill{suffix}", self.prefill,
                                  (self.prefill_batch_spec(B, S, multimodal=mm),), "prefill"))
            out.append(EntryPoint(f"decode_step{suffix}", self.decode_step,
                                  (self.abstract_cache(B, S, multimodal=mm), self.decode_batch_spec(B)), "decode"))
        return out


def build_model(cfg: ModelConfig, *, param_dtype: Optional[torch.dtype] = None) -> Model:
    return Model(cfg, param_dtype=param_dtype)
