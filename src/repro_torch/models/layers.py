"""Common layers: RMSNorm, RoPE, SwiGLU MLP, embeddings, cross-entropy
(``repro.models.layers`` counterpart, same numerics contract).

All weights are 2D matrices (d_in, d_out); head structure is recovered by
reshape at use time.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models.spec import ParamSpec


def rmsnorm_spec(d: int) -> ParamSpec:
    return ParamSpec((d,), ("embed",), init="ones")


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm with fp32 variance accumulation and model-dtype elementwise math."""
    var = torch.sum(x * x, dim=-1, keepdim=True, dtype=torch.float32) / x.shape[-1]
    r = torch.rsqrt(var + eps).to(x.dtype)
    return x * r * scale.to(x.dtype)


def rope_frequencies(head_dim: int, theta: float, device) -> torch.Tensor:
    """(head_dim//2,) inverse frequencies."""
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta ** exponent)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., S, H, hd); positions: broadcastable to (..., S)."""
    hd = x.shape[-1]
    inv = rope_frequencies(hd, theta, x.device)
    ang = positions[..., :, None].to(torch.float32) * inv  # (..., S, hd/2)
    cos = torch.cos(ang)[..., :, None, :]
    sin = torch.sin(ang)[..., :, None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def swiglu_spec(d_model: int, d_ff: int) -> dict:
    return {
        "w_gate": ParamSpec((d_model, d_ff), ("embed", "ffn")),
        "w_up": ParamSpec((d_model, d_ff), ("embed", "ffn")),
        "w_down": ParamSpec((d_ff, d_model), ("ffn", "embed")),
    }


def swiglu(params: dict, x: torch.Tensor) -> torch.Tensor:
    g = x @ params["w_gate"].to(x.dtype)
    u = x @ params["w_up"].to(x.dtype)
    h = F.silu(g.to(torch.float32)).to(x.dtype) * u
    return h @ params["w_down"].to(x.dtype)


def embedding_spec(vocab: int, d_model: int) -> ParamSpec:
    # rows:0 — row-indexed access: vocab row-groups may be tiered
    return ParamSpec((vocab, d_model), ("vocab", "embed"), scale=1.0, access="rows:0")


def embed(table: torch.Tensor, tokens: torch.Tensor, dtype: torch.dtype, d_model: int) -> torch.Tensor:
    """Row lookup times sqrt(d_model), in the model dtype."""
    x = table[tokens].to(dtype)
    return x * torch.tensor(math.sqrt(d_model), dtype=torch.float32).to(dtype)


def logits_from_embedding(x: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    return x @ table.to(x.dtype).T


def _xent(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Per-position logsumexp(logits) - logits[label], in fp32."""
    logits = logits.to(torch.float32)
    gold = torch.gather(logits, -1, labels.to(torch.int64)[..., None])[..., 0]
    return torch.logsumexp(logits, dim=-1) - gold


def softmax_xent(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean cross-entropy; logits (..., V) in any float dtype, fp32 softmax."""
    return torch.mean(_xent(logits, labels))


def chunked_xent(x: torch.Tensor, table: torch.Tensor, labels: torch.Tensor, chunk: int) -> torch.Tensor:
    """Mean cross-entropy without the whole (B, S, V) logits: logits are
    made one sequence chunk at a time and their fp32 sums added in chunk
    order. ``chunk`` must divide S."""
    B, S, _ = x.shape
    if S % chunk:
        raise ValueError(f"sequence {S} is not a multiple of the logits chunk {chunk}")
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for c in range(0, S, chunk):
        total = total + torch.sum(_xent(logits_from_embedding(x[:, c:c + chunk], table), labels[:, c:c + chunk]))
    return total / (B * S)


# -- sharded forms (a rank's local blocks; ``sharding.comm``) ------------------
#
# Each takes ``Shard`` leaves (``sharding.rules.Shard``: the rank's block, the
# leaf's whole shape and spec) and a ``Comm``. FSDP: a weight's ``embed`` dim
# is all-gathered over ``data`` at its use and dropped after it. TP: a dim the
# rules split over ``model`` stays split, and the partial sums it leaves are
# all-reduced over ``model``. Under autograd the replicated input of a
# column-parallel weight goes through ``comm.enter`` (``sharding.comm``).


def swiglu_sharded(params: dict, x: torch.Tensor, comm) -> torch.Tensor:
    """``swiglu`` with ``ffn`` column-parallel (gate, up) and row-parallel
    (down) over ``model`` where the rules split it: the down projection's
    partial sums are all-reduced over ``model``."""
    for ax in params["w_gate"].split(1):
        x = comm.enter(x, ax)
    g = x @ params["w_gate"].gathered(comm, ("data",)).to(x.dtype)
    u = x @ params["w_up"].gathered(comm, ("data",)).to(x.dtype)
    h = F.silu(g.to(torch.float32)).to(x.dtype) * u
    y = h @ params["w_down"].gathered(comm, ("data",)).to(x.dtype)
    for ax in params["w_down"].split(0):
        y = comm.all_reduce(y, ax)
    return y


def embed_sharded(table, tokens: torch.Tensor, dtype: torch.dtype, d_model: int, comm) -> torch.Tensor:
    """Vocab-parallel ``embed``: each ``model`` rank looks up the ids inside
    its vocab rows (zeros for the others) and the rows are summed over
    ``model``; exactly one rank holds each id, so the sum is the row itself."""
    t = table.gathered(comm, ("data",))
    if not table.split(0):
        x = t[tokens].to(dtype)
    else:
        local = tokens - table.start(0, comm)
        inside = (local >= 0) & (local < t.shape[0])
        x = torch.where(inside[..., None], t[local.clamp(0, t.shape[0] - 1)].to(dtype), 0)
        for ax in table.split(0):
            x = comm.all_reduce(x, ax)
    return x * torch.tensor(math.sqrt(d_model), dtype=torch.float32).to(dtype)


def logits_sharded(x: torch.Tensor, table) -> torch.Tensor:
    """Vocab-parallel ``logits_from_embedding``: the logits of this rank's
    vocab rows only (``table`` already gathered over ``data``)."""
    return x @ table.to(x.dtype).T


class _VocabParallelLSE(torch.autograd.Function):
    """logsumexp over a vocab split over mesh dims ``dims``, from each rank's
    (..., V_loc) fp32 block of the logits: the block's max all-reduced (max)
    and its sum of exponentials all-reduced (sum). The backward needs no
    collective: each rank's block of the softmax is exp(z - lse)."""

    @staticmethod
    def forward(ctx, z, comm, dims):
        m = torch.amax(z, dim=-1, keepdim=True)
        for ax in dims:
            m = comm.all_reduce(m, ax, "max")
        s = torch.sum(torch.exp(z - m), dim=-1)
        for ax in dims:
            s = comm.all_reduce(s, ax)
        lse = torch.log(s) + m[..., 0]
        ctx.save_for_backward(z, lse)
        return lse

    @staticmethod
    def backward(ctx, grad):
        z, lse = ctx.saved_tensors
        return grad[..., None] * torch.exp(z - lse[..., None]), None, None


def _xent_sharded(z: torch.Tensor, labels: torch.Tensor, start: int, dims: tuple, comm) -> torch.Tensor:
    """``_xent`` on a rank's (..., V_loc) block of the logits, whose vocab
    rows start at ``start``: the logsumexp over every rank's rows
    (``_VocabParallelLSE``), and each label's logit read by the rank that
    holds its row (zeros elsewhere) and summed over ``dims``."""
    z = z.to(torch.float32)
    local = labels.to(torch.int64) - start
    inside = (local >= 0) & (local < z.shape[-1])
    gold = torch.gather(z, -1, local.clamp(0, z.shape[-1] - 1)[..., None])[..., 0]
    gold = torch.where(inside, gold, torch.zeros_like(gold))
    for ax in dims:
        gold = comm.all_reduce(gold, ax)
    return _VocabParallelLSE.apply(z, comm, dims) - gold


def xent_sharded(x: torch.Tensor, table, labels: torch.Tensor, chunk: int, comm) -> torch.Tensor:
    """The mean cross-entropy of this rank's rows (``x`` the final hidden
    states, ``table`` the head's ``Shard``, gathered over ``data`` here):
    ``softmax_xent`` / ``chunked_xent`` as they are where no mesh dim above
    1 splits the vocab, else vocab-parallel (``_xent_sharded`` on the rank's
    logits block, the hidden states entering the ``model`` region first),
    per sequence chunk of ``chunk`` when it is set."""
    t = table.gathered(comm, ("data",))
    dims = tuple(ax for ax in table.split(0) if comm.size(ax) > 1)
    if not dims:
        if chunk:
            return chunked_xent(x, t, labels, chunk)
        return softmax_xent(logits_from_embedding(x, t), labels)
    for ax in dims:
        x = comm.enter(x, ax)
    start = table.start(0, comm)
    B, S, _ = x.shape
    if not chunk:
        return torch.mean(_xent_sharded(logits_sharded(x, t), labels, start, dims, comm))
    if S % chunk:
        raise ValueError(f"sequence {S} is not a multiple of the logits chunk {chunk}")
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for c in range(0, S, chunk):
        z = logits_sharded(x[:, c:c + chunk], t)
        total = total + torch.sum(_xent_sharded(z, labels[:, c:c + chunk], start, dims, comm))
    return total / (B * S)


def greedy_sharded(logits: torch.Tensor, vocab_start: int, vocab_dims: tuple, batch_dims: tuple,
                   comm) -> torch.Tensor:
    """Greedy ids (int64) of every row of the batch, the same on every
    rank, from each rank's (rows, vocab) block of the logits: each block's
    max and its first index, all-gathered over the vocab's mesh dims, the
    largest taken with ties to the lowest rank (so to the lowest id, as
    ``torch.argmax``), then the rows all-gathered over the batch's."""
    best, idx = logits.max(dim=-1)
    idx = idx + vocab_start
    if vocab_dims:
        vals = torch.stack([best.to(torch.float32), idx.to(torch.float32)], dim=-1)[..., None, :]
        for ax in reversed(vocab_dims):
            vals = comm.all_gather(vals, ax, vals.dim() - 2)
        pick = vals[..., 0].argmax(dim=-1, keepdim=True)
        idx = vals[..., 1].gather(-1, pick)[..., 0].to(torch.int64)
    for ax in reversed(batch_dims):
        idx = comm.all_gather(idx, ax, 0)
    return idx
