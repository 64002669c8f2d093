"""The three kernels of the serving path, each beside its plain version.

Counterparts of the Pallas kernels in ``distar_tpu/ops/pallas_kernels.py``:

* ``masked_attention``       — softmax(mask(q k^T / sqrt(Dh), -1e9)) v
* ``scatter_add_connection`` — per-batch scatter-add of entity rows onto the
  flattened map, entity order, collisions sum
* ``scatter_add_onehot``     — the same sum as onehot(idx)^T . emb

Each wrapper takes the plain PyTorch version for a tensor that lies on the
CPU. For a CUDA tensor it launches the hand-written kernel
(``csrc/<name>.cu``, built at first use by ``build.py``) or raises: there is
no fallback. ``launch_counts[name]`` rises by one per wrapper call that
reached the kernel (``scatter_add_connection`` runs as two launches, a zero
pass and an owner pass, and ``masked_attention`` as a plan and the
attention; each counts once), so a run can show that its main
path went through the kernels.

Each wrapper is differentiable: when a gradient is needed it runs through a
``torch.autograd.Function`` whose forward is the same call (kernel or plain
version) and whose backward is the JAX package's formula in plain PyTorch,
on either device, as the JAX package's ``custom_vjp`` backward passes are
plain XLA: attention recomputes the softmax in float32
(``pallas_kernels.py:110-126``), each scatter gathers the output gradient at
the clipped cells (``:202-207``, ``:287-294``). The backward launches no
kernel, so ``launch_counts`` counts forward calls only.
"""
from __future__ import annotations

import torch

from . import build

NEG_INF = -1e9
ATTENTION_KEY_TILE = 32  # keys per tile of masked_attention.cu (BK); tiles with no valid key are skipped
ONEHOT_CHUNK = 2048  # cells per program, as the Pallas one-hot kernel
SCATTER_MAX_D = 128  # the scatter kernels' widest row (shared memory per block)

launch_counts = {name: 0 for name in build.KERNELS}


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


def _check_cuda(name: str, tensors, dtypes) -> None:
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{name}: tensors on {t.device} and {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: non-contiguous input")
    if tensors[0].dtype not in dtypes:
        raise TypeError(f"{name}: dtype {tensors[0].dtype} not in {dtypes}")


def _launch(name: str, device: torch.device, *args) -> None:
    fn = getattr(build.load(name), f"{name}_fwd")
    with torch.cuda.device(device):
        err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA kernel launch failed with cudaError {err}")
    launch_counts[name] += 1


def _dispatch(name: str, t: torch.Tensor) -> bool:
    """True for the plain version (a CPU tensor), False for the kernel (a
    CUDA tensor); any other device raises."""
    if t.device.type == "cpu":
        return True
    if t.device.type != "cuda":
        raise RuntimeError(f"{name}: no kernel for device {t.device}")
    return False


# --------------------------------------------------------------- attention
def masked_attention_plain(q, k, v, mask, upcast: bool = True):
    """Softmax attention with the -1e9 key fill after the scale, written back
    in the input dtype. ``upcast`` computes in f32 (the Pallas kernel's
    numerics); without it the math stays in the input dtype (the JAX 'xla'
    attention's numerics)."""
    dtype = q.dtype
    if upcast:
        q, k, v = q.float(), k.float(), v.float()
    score = torch.einsum("bhqd,bhkd->bhqk", q, k) / (float(q.shape[-1]) ** 0.5)
    score = score.masked_fill(~mask.bool()[:, None, None, :], NEG_INF)
    p = torch.softmax(score, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, v).to(dtype)


def _needs_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def masked_attention_backward(q, k, v, mask, dout):
    """The JAX package's attention backward: recompute the scores and the
    softmax in float32 whatever the input dtype, then dv = p^T dout,
    dp = dout v^T, ds = p * (dp - sum(dp * p)), dq = ds k * scale and
    dk = ds^T q * scale, each cast back to its input's dtype. Kept as the
    JAX package has it where it is not the derivative: for a sample with no
    valid key p is uniform and ds does not vanish, so dq and dk are nonzero
    though the output (mean V) does not depend on q or k."""
    with torch.autocast(q.device.type, enabled=False):
        qf, kf, vf, d = q.float(), k.float(), v.float(), dout.float()
        scale = 1.0 / (q.shape[-1] ** 0.5)
        score = torch.einsum("bhqd,bhkd->bhqk", qf, kf) * scale
        score = score.masked_fill(~mask.bool()[:, None, None, :], NEG_INF)
        p = torch.softmax(score, dim=-1)
        dv = torch.einsum("bhqk,bhqd->bhkd", p, d)
        dp = torch.einsum("bhqd,bhkd->bhqk", d, vf)
        ds = p * (dp - (dp * p).sum(dim=-1, keepdim=True))
        dq = torch.einsum("bhqk,bhkd->bhqd", ds, kf) * scale
        dk = torch.einsum("bhqk,bhqd->bhkd", ds, qf) * scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class _MaskedAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, mask):
        ctx.save_for_backward(q, k, v, mask)
        return _masked_attention(q, k, v, mask)

    @staticmethod
    def backward(ctx, dout):
        return (*masked_attention_backward(*ctx.saved_tensors, dout.contiguous()), None)


def masked_attention(q, k, v, mask):
    """q, k, v: [B, H, N, Dh] (float32 or bfloat16; on the card Dh a
    multiple of 4 up to 128, any N); mask: [B, N] key validity. Returns
    [B, H, N, Dh] in the input dtype, softmax and sums in float32. The kernel
    runs both products on tensor cores (3xTF32 for float32 inputs).
    Differentiable in q, k and v (:func:`masked_attention_backward`)."""
    if _needs_grad(q, k, v):
        return _MaskedAttention.apply(q, k, v, mask)
    return _masked_attention(q, k, v, mask)


def _masked_attention(q, k, v, mask):
    if _dispatch("masked_attention", q):
        return masked_attention_plain(q, k, v, mask)
    B, H, N, Dh = q.shape
    if k.shape != q.shape or v.shape != q.shape or tuple(mask.shape) != (B, N):
        raise ValueError(f"masked_attention: shapes q{tuple(q.shape)} k{tuple(k.shape)} "
                         f"v{tuple(v.shape)} mask{tuple(mask.shape)}")
    if Dh > 128 or Dh % 4:
        raise ValueError(f"masked_attention: head dim {Dh} (kernel takes a multiple of 4, <= 128)")
    mask = mask.to(torch.bool).contiguous()
    _check_cuda("masked_attention", (q, k, v, mask), (torch.float32, torch.bfloat16))
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("masked_attention: q, k, v dtypes differ")
    out = torch.empty_like(q)
    # the kernel's plan of kept key tiles and of the order of its blocks
    ntiles = -(-N // ATTENTION_KEY_TILE)
    plan = torch.empty(B * (2 + 2 * ntiles), dtype=torch.int32, device=q.device)
    _launch("masked_attention", q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(),
            mask.data_ptr(), plan.data_ptr(), out.data_ptr(), B, H, N, Dh, 1.0 / (Dh ** 0.5),
            int(q.dtype == torch.bfloat16))
    return out


# ----------------------------------------------------------------- scatter
def scatter_add_plain(embeddings, flat_idx, hw: int):
    """Entity-order scatter-add: zero [B, hw, D], then add row i of every
    batch at its clipped cell, for i = 0..N-1, in the input dtype. Within
    one i the B rows hit distinct batches, so the sum order is the loop
    kernel's exactly."""
    B, N, D = embeddings.shape
    idx = flat_idx.long().clamp(0, hw - 1)
    flat = idx + torch.arange(B, device=idx.device)[:, None] * hw
    out = torch.zeros(B * hw, D, dtype=embeddings.dtype, device=embeddings.device)
    for i in range(N):
        out[flat[:, i]] += embeddings[:, i]
    return out.view(B, hw, D)


def scatter_add_onehot_plain(embeddings, flat_idx, hw: int):
    """The one-hot formulation: per chunk of cells, onehot(idx)^T . emb in
    f32 (a matmul; its sum order is the matmul's, not entity order)."""
    B, N, D = embeddings.shape
    idx = flat_idx.long().clamp(0, hw - 1)
    out = []
    for c0 in range(0, hw, ONEHOT_CHUNK):
        cells = torch.arange(c0, min(c0 + ONEHOT_CHUNK, hw), device=idx.device)
        onehot = (idx[:, :, None] == cells).float()  # [B, N, chunk]
        out.append(torch.einsum("bnc,bnd->bcd", onehot, embeddings.float()))
    return torch.cat(out, dim=1).to(embeddings.dtype)


def _scatter_kernel(name: str, embeddings, flat_idx, hw: int):
    B, N, D = embeddings.shape
    if tuple(flat_idx.shape) != (B, N):
        raise ValueError(f"{name}: idx shape {tuple(flat_idx.shape)} for embeddings "
                         f"{tuple(embeddings.shape)}")
    if D > SCATTER_MAX_D:
        raise ValueError(f"{name}: row width {D} (the kernel takes <= {SCATTER_MAX_D})")
    idx = flat_idx.clamp(0, hw - 1).to(torch.int32).contiguous()
    # the loop kernel also adds bfloat16 rows in bfloat16, as the Pallas loop
    # kernel does; the one-hot kernel sums float32 only
    loop = name == "scatter_add_connection"
    _check_cuda(name, (embeddings, idx), (torch.float32, torch.bfloat16) if loop else (torch.float32,))
    out = torch.empty(B, hw, D, dtype=embeddings.dtype, device=embeddings.device)
    args = [embeddings.data_ptr(), idx.data_ptr(), out.data_ptr(), B, N, D, hw]
    if loop:
        args.append(int(embeddings.dtype == torch.bfloat16))
    _launch(name, embeddings.device, *args)
    return out


def scatter_add_backward(flat_idx, dout, hw: int):
    """The JAX package's scatter backward, for both kernels: the gradient of
    row n of batch b is dout[b, clip(idx[b, n], 0, hw - 1)]. (The JAX one-hot
    backward also zeroes rows whose index lies outside [0, hw); its public
    wrapper clips first, as these wrappers do, so that guard never fires and
    is not repeated here.)"""
    idx = flat_idx.long().clamp(0, hw - 1)
    return dout.gather(1, idx[..., None].expand(-1, -1, dout.shape[-1]))


class _ScatterAdd(torch.autograd.Function):
    @staticmethod
    def forward(ctx, embeddings, flat_idx, hw: int, forward):
        ctx.hw = hw
        ctx.save_for_backward(flat_idx)
        return forward(embeddings, flat_idx, hw)

    @staticmethod
    def backward(ctx, dout):
        (flat_idx,) = ctx.saved_tensors
        return scatter_add_backward(flat_idx, dout.contiguous(), ctx.hw), None, None, None


def scatter_add_connection(embeddings, flat_idx, hw: int):
    """embeddings: [B, N, D] float32 or bfloat16 (invalid entities zeroed; D
    <= SCATTER_MAX_D on the card); flat_idx: [B, N] int cell index, clipped
    here to [0, hw-1]. Returns [B, hw, D] in the input dtype, each cell's
    rows added in entity order from +0.0, every add rounded to that dtype
    (the Pallas loop kernel's numerics): ``scatter_add_plain``'s result bit
    for bit. Differentiable in ``embeddings`` (:func:`scatter_add_backward`)."""
    if _needs_grad(embeddings):
        return _ScatterAdd.apply(embeddings, flat_idx, hw, _scatter_add_connection)
    return _scatter_add_connection(embeddings, flat_idx, hw)


def _scatter_add_connection(embeddings, flat_idx, hw: int):
    if _dispatch("scatter_add_connection", embeddings):
        return scatter_add_plain(embeddings, flat_idx, hw)
    return _scatter_kernel("scatter_add_connection", embeddings, flat_idx, hw)


def scatter_add_onehot(embeddings, flat_idx, hw: int):
    """The same function as :func:`scatter_add_connection`; the kernel gives
    the loop's f32 result bit for bit (its plain version, a matmul, does
    not). Differentiable in ``embeddings``, with the same backward."""
    if _needs_grad(embeddings):
        return _ScatterAdd.apply(embeddings, flat_idx, hw, _scatter_add_onehot)
    return _scatter_add_onehot(embeddings, flat_idx, hw)


def _scatter_add_onehot(embeddings, flat_idx, hw: int):
    if _dispatch("scatter_add_onehot", embeddings):
        return scatter_add_onehot_plain(embeddings, flat_idx, hw)
    return _scatter_kernel("scatter_add_onehot", embeddings, flat_idx, hw)
