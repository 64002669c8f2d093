"""Ring attention: exact attention over a set axis split across the mesh's
``sp`` ranks.

Counterpart of ``distar_tpu.parallel.ring_attention`` (Liu et al., Ring
Attention, 2023). Each rank holds a block of the queries and a block of
the keys and values; over ``sp`` steps it attends its queries against the
block it holds while the K/V/mask blocks move one hop round the ring
(rank i sends to i+1, as JAX's ``ppermute`` perm), and a running online
softmax (row max and denominator carried, flash-attention style) makes
the result exactly the softmax over the whole axis. Masked scores are
-1e9 after the scale, as in every attention of the package.

``ring_attention`` is the per-rank body, an autograd function: JAX
differentiates through ``ppermute``, whose transpose rotates the other
way; here the backward recomputes each block's probabilities from the
saved row max and denominator, and the key and value gradients travel round the
ring with their blocks, home after the last hop.

``ring_self_attention`` is the wrapper the model calls: q, k, v and mask
are whole on every sp rank (the port keeps the batch whole across sp);
each rank takes its block of the set axis, runs the ring, and the output
blocks are gathered whole again. Backward mirrors it (the gathered
output's gradient is cut to the rank's block; the blocks' input
gradients are gathered whole), so everything outside attention sees the
same tensors and gradients on every sp rank. With no sp mesh it is a ring
of one; a set axis that sp does not divide falls back to the plain
attention, as JAX's falls back to XLA.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

NEG_INF = -1e9


def _rotate(tensors, group, n: int, idx: int):
    """Every tensor sent one hop round the ring: this rank's to rank idx+1,
    rank idx-1's received (as contiguous copies)."""
    if group is None or n == 1:
        return list(tensors)
    ranks = dist.get_process_group_ranks(group)
    nxt, prv = ranks[(idx + 1) % n], ranks[(idx - 1) % n]
    out, ops = [], []
    for t in tensors:
        wire = t.to(torch.uint8) if t.dtype == torch.bool else t.contiguous()
        buf = torch.empty_like(wire)
        ops.append(dist.P2POp(dist.isend, wire, nxt, group))
        ops.append(dist.P2POp(dist.irecv, buf, prv, group))
        out.append((buf, t.dtype))
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return [b.to(torch.bool) if dt == torch.bool else b for b, dt in out]


def _scores(q, k, mask, scale):
    s = torch.einsum("bhqd,bhkd->bhqk", q, k) * scale
    return torch.where(mask[:, None, None, :], s, torch.full_like(s, NEG_INF))


class _Ring(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, mask, group, n, idx):
        scale = 1.0 / (q.shape[-1] ** 0.5)
        acc = torch.zeros_like(q)
        denom = q.new_zeros(q.shape[:-1])
        row_max = torch.full_like(denom, NEG_INF)
        k_blk, v_blk, m_blk = k, v, mask
        for step in range(n):
            score = _scores(q, k_blk, m_blk, scale)
            new_max = torch.maximum(row_max, score.amax(dim=-1))
            correction = torch.exp(row_max - new_max)
            p = torch.exp(score - new_max[..., None])
            acc = acc * correction[..., None] + torch.einsum("bhqk,bhkd->bhqd", p, v_blk)
            denom = denom * correction + p.sum(dim=-1)
            row_max = new_max
            if step < n - 1:
                k_blk, v_blk, m_blk = _rotate((k_blk, v_blk, m_blk), group, n, idx)
        denom = denom.clamp_min(1e-20)
        out = acc / denom[..., None]
        # max and denominator kept apart (not as a log-sum-exp): near the
        # -1e9 fill of a row with no valid key, f32 cannot hold max + log(denom)
        ctx.save_for_backward(q, k, v, mask, out, row_max, denom)
        ctx.ring = (group, n, idx)
        return out

    @staticmethod
    def backward(ctx, gout):
        q, k, v, mask, out, row_max, denom = ctx.saved_tensors
        group, n, idx = ctx.ring
        scale = 1.0 / (q.shape[-1] ** 0.5)
        gout = gout.contiguous()
        delta = (gout * out).sum(dim=-1)  # [B, H, Nq]
        dq = torch.zeros_like(q)
        k_blk, v_blk, m_blk = k, v, mask
        dk_blk, dv_blk = torch.zeros_like(k), torch.zeros_like(v)
        for _ in range(n):
            p = torch.exp(_scores(q, k_blk, m_blk, scale) - row_max[..., None]) / denom[..., None]
            dv_blk = dv_blk + torch.einsum("bhqk,bhqd->bhkd", p, gout)
            dp = torch.einsum("bhqd,bhkd->bhqk", gout, v_blk)
            ds = p * (dp - delta[..., None])
            ds = torch.where(m_blk[:, None, None, :], ds, torch.zeros_like(ds)) * scale
            dq = dq + torch.einsum("bhqk,bhkd->bhqd", ds, k_blk)
            dk_blk = dk_blk + torch.einsum("bhqk,bhqd->bhkd", ds, q)
            # n hops in all: each block's gradients come home with it
            k_blk, v_blk, m_blk, dk_blk, dv_blk = _rotate((k_blk, v_blk, m_blk, dk_blk, dv_blk),
                                                          group, n, idx)
        return dq, dk_blk, dv_blk, None, None, None, None


def ring_attention(q, k, v, mask: Optional[torch.Tensor] = None, *, group=None, axis_size: int = 1,
                   axis_index: int = 0):
    """The per-rank body: q [B, H, Nq_local, D], k/v [B, H, Nk_local, D],
    mask [B, Nk_local] key validity; ``group`` is the sp process group
    (None for a ring of one), ``axis_index`` this rank's place on it."""
    if mask is None:
        mask = torch.ones(k.shape[0], k.shape[2], dtype=torch.bool, device=k.device)
    return _Ring.apply(q, k, v, mask.bool(), group, axis_size, axis_index)


def _all_gather_cat(x, group, n, dim):
    parts = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim)


class _Block(torch.autograd.Function):
    """This rank's block of ``dim``; backward gathers the blocks' gradients
    whole (every rank took its own block of the same tensor)."""

    @staticmethod
    def forward(ctx, x, dim, group, n, idx):
        ctx.args = (dim, group, n)
        step = x.shape[dim] // n
        return x.narrow(dim, idx * step, step).contiguous()

    @staticmethod
    def backward(ctx, g):
        dim, group, n = ctx.args
        return _all_gather_cat(g, group, n, dim), None, None, None, None


class _Whole(torch.autograd.Function):
    """The blocks gathered whole along ``dim``; backward cuts the gradient
    (the same on every rank) to this rank's block."""

    @staticmethod
    def forward(ctx, x, dim, group, n, idx):
        ctx.args = (dim, n, idx)
        return _all_gather_cat(x, group, n, dim)

    @staticmethod
    def backward(ctx, g):
        dim, n, idx = ctx.args
        step = g.shape[dim] // n
        return g.narrow(dim, idx * step, step), None, None, None, None


def ring_self_attention(q, k, v, mask: Optional[torch.Tensor], mesh=None):
    """Attention of whole q, k, v [B, H, N, D] and mask [B, N] with the set
    axis split over ``mesh``'s sp ranks; the output whole on every one."""
    from ..ops.kernels import masked_attention_plain

    if mask is None:
        mask = torch.ones(q.shape[0], q.shape[2], dtype=torch.bool, device=q.device)
    mask = mask.bool()
    sp = mesh.shape["sp"] if mesh is not None else 1
    if sp == 1:
        return ring_attention(q, k, v, mask)
    if q.shape[2] % sp:
        return masked_attention_plain(q, k, v, mask, upcast=False)
    group, idx = mesh.group("sp"), mesh.index("sp")
    step = q.shape[2] // sp
    ql, kl, vl = (_Block.apply(t, 2, group, sp, idx) for t in (q, k, v))
    ml = mask.narrow(1, idx * step, step).contiguous()
    out = ring_attention(ql, kl, vl, ml, group=group, axis_size=sp, axis_index=idx)
    return _Whole.apply(out, 2, group, sp, idx)
