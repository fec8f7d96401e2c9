"""Plain PyTorch versions of every kernel (port of ``repro/kernels/ref.py``).

Two grades, as in the JAX package:

* ``*_dense_ref`` — the mathematical oracles: no tiling, no online
  accumulation, the dense score matrix.
* ``flash_attention_ref`` / ``decode_attention_ref`` — the served
  ``torch``-tier versions: kv-block-chunked online softmax that skips
  causally dead and out-of-window blocks, the same block liveness as the
  kernels.

Control values (``kv_len``, ``index``, ``subnet_id``, widths) may be Python
ints or 0-d integer tensors on the data's device; a tensor is used as data
(masks, ``index_select``), never read back to the host, except where
``decode_attention_ref`` picks its live cache prefix (CPU path only).

The prefill, norm and matmul versions accumulate in fp32, or in fp64 for
fp64 inputs (:func:`acc`), so the gradient tests can check them in fp64.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def acc(t: torch.Tensor) -> torch.Tensor:
    """``t`` in its accumulation type: fp64 for fp64, else fp32."""
    return t.to(torch.float64 if t.dtype == torch.float64 else torch.float32)


def _unreadable(t) -> bool:
    """Whether ``t`` has no values the host could read: a DTensor or a
    fake tensor (the dry-run's)."""
    return type(t).__name__ in ("DTensor", "FakeTensor")


def take_row(table: torch.Tensor, idx) -> torch.Tensor:
    """``table[idx]`` for an int or a 0-d integer tensor, without a host
    read: indexing with a 0-d tensor would call ``.item()``."""
    if isinstance(idx, torch.Tensor):
        return torch.index_select(table, 0, idx.reshape(1).long())[0]
    return table[int(idx)]


def sliced_matmul_ref(x, w, active_in, active_out):
    """y = x[..., :k_in] @ w[:k_in, :k_out], zero-padded to w.shape[-1];
    with a stack w (E, K, N) and x (E, M, K), each ``x[e] @ w[e]`` alike.

    WeightSlice semantics: channels beyond the active widths contribute
    nothing and produce nothing."""
    K, N = w.shape[-2:]
    xm = x * (torch.arange(K, device=x.device) < active_in).to(x.dtype)
    y = xm.float() @ w.float()
    return (y * (torch.arange(N, device=x.device) < active_out).to(y.dtype)
            ).to(x.dtype)


def _attention_mask(q_pos, k_pos, *, causal, window, kv_len):
    mask = torch.ones((q_pos.shape[0], k_pos.shape[0]), dtype=torch.bool,
                      device=k_pos.device)
    if kv_len is not None:
        mask &= k_pos[None, :] < kv_len
    if causal:
        mask &= k_pos[None, :] <= q_pos[:, None]
    if window:
        mask &= k_pos[None, :] > q_pos[:, None] - window
    return mask


def flash_attention_dense_ref(q, k, v, *, causal: bool = True,
                              window: int = 0, kv_len=None, scale=None):
    """Full-softmax attention oracle. q: (B,Hq,Sq,d); k/v: (B,Hkv,Sk,d)."""
    B, Hq, Sq, d = q.shape
    _, Hkv, Sk, _ = k.shape
    G = Hq // Hkv
    scale = scale if scale is not None else d ** -0.5
    dev = q.device
    qf = acc(q.reshape(B, Hkv, G, Sq, d))
    s = torch.einsum("bhgqd,bhkd->bhgqk", qf, acc(k)) * scale
    mask = _attention_mask(torch.arange(Sq, device=dev),
                           torch.arange(Sk, device=dev), causal=causal,
                           window=window, kv_len=kv_len)
    s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    # rows with no valid key attend to nothing (match kernel semantics)
    p = p * mask.any(-1)[:, None]
    o = torch.einsum("bhgqk,bhkd->bhgqd", p, acc(v))
    return o.reshape(B, Hq, Sq, d).to(v.dtype)


def _live_kv_range(q0: int, q1: int, n_k: int, kb: int, causal: bool,
                   window: int, static_kv_len) -> tuple:
    """Static [lo, hi) kv-block range live for absolute q rows [q0, q1).

    A kv block is dead when its first key is past the causal frontier of
    the last q row, or its last key is below the window floor of the first
    q row. An int ``kv_len`` also clamps the top; a tensor one is left to
    the per-element mask."""
    lo, hi = 0, n_k
    if causal:
        hi = min(hi, (q1 - 1) // kb + 1)
    if window:
        lo = min(max(lo, (q0 - window + 1) // kb), n_k)
    if isinstance(static_kv_len, int):
        hi = min(hi, -(-static_kv_len // kb))
    return lo, hi


def flash_attention_ref(q, k, v, *, causal: bool = True, window: int = 0,
                        kv_len=None, scale=None, q_offset=0,
                        q_block: int = 256, kv_block: int = 256):
    """Block-skipping online-softmax attention (the served ``torch`` tier).

    Same semantics as :func:`flash_attention_dense_ref`, plus ``q_offset``
    (absolute position of q row 0, as ``repro.models.attention
    .flash_attention`` takes it) and the chunk sizes. Dead blocks carry
    exactly zero softmax mass, so skipping them changes nothing but the
    fp32 summation order. Skipping needs an int ``q_offset``."""
    B, Hq, Sq, d = q.shape
    _, Hkv, Sk, _ = k.shape
    G = Hq // Hkv
    scale = scale if scale is not None else d ** -0.5
    qb = min(q_block, Sq) if q_block else Sq
    kb = min(kv_block, Sk) if kv_block else Sk
    n_q, n_k = -(-Sq // qb), -(-Sk // kb)
    dev = q.device
    off_static = q_offset if isinstance(q_offset, int) else None

    qf = acc(q.reshape(B, Hkv, G, Sq, d))
    kf = acc(k)
    vf = acc(v)

    outs = []
    for qi in range(n_q):
        q0, q1 = qi * qb, min((qi + 1) * qb, Sq)
        q_pos = q_offset + torch.arange(q0, q1, device=dev)
        lo, hi = 0, n_k
        if off_static is not None:
            lo, hi = _live_kv_range(off_static + q0, off_static + q1, n_k,
                                    kb, causal, window, kv_len)
        m = torch.full((B, Hkv, G, q1 - q0), NEG_INF, dtype=qf.dtype,
                       device=dev)
        l = torch.zeros((B, Hkv, G, q1 - q0), dtype=qf.dtype, device=dev)
        o = torch.zeros((B, Hkv, G, q1 - q0, d), dtype=qf.dtype, device=dev)
        for ki in range(lo, hi):
            k0, k1 = ki * kb, min((ki + 1) * kb, Sk)
            s = torch.einsum("bhgqd,bhkd->bhgqk", qf[:, :, :, q0:q1],
                             kf[:, :, k0:k1]) * scale
            mask = _attention_mask(q_pos, torch.arange(k0, k1, device=dev),
                                   causal=causal, window=window,
                                   kv_len=kv_len)
            s = torch.where(mask, s, NEG_INF)
            m_new = torch.maximum(m, s.amax(-1))
            # mask again: a fully dead row has s == m_new == NEG_INF and
            # would otherwise get exp(0) = 1 (the kernel does the same)
            p = torch.exp(s - m_new[..., None]) * mask
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(-1)
            o = o * corr[..., None] + torch.einsum(
                "bhgqk,bhkd->bhgqd", p, vf[:, :, k0:k1])
            m = m_new
        outs.append(o / torch.clamp(l, min=1e-30)[..., None])
    o = torch.cat(outs, dim=3)
    return o.reshape(B, Hq, Sq, d).to(v.dtype)


def head_active(Hq: int, Hkv: int, head_width, device) -> torch.Tensor:
    """Which of ``Hq`` query heads over ``Hkv`` kv heads are active at
    ``head_width`` (an int or a 0-d int tensor): under GQA a prefix of
    every kv group, ``h % G < head_width // Hkv``; under MHA the prefix
    ``h < head_width``."""
    G = Hq // Hkv
    iota = torch.arange(Hq, device=device)
    if G > 1:
        return (iota % G) < head_width // Hkv
    return iota < head_width


def zero_inactive_heads(o, Hkv: int, head_width):
    """o: (B, Hq, S, d) with the outputs of inactive heads set to 0;
    ``head_width`` None keeps every head."""
    if head_width is None:
        return o
    m = head_active(o.shape[1], Hkv, head_width, o.device)
    return o * m.reshape(1, -1, 1, 1).to(o.dtype)


def _decode_mask(index, Smax: int, window: int, device):
    pos = torch.arange(Smax, device=device)
    if window:
        age = torch.remainder(index - pos, Smax)          # rolling buffer
        limit = (min(window, index + 1) if isinstance(index, int)
                 else torch.clamp(index + 1, max=window))
        return age < limit
    return pos <= index


def decode_attention_dense_ref(q, k_cache, v_cache, index, *,
                               window: int = 0):
    """Single-token attention oracle over the whole cache. q: (B,Hq,1,d);
    caches: (B,Hkv,Smax,d); index = current absolute position."""
    B, Hq, _, d = q.shape
    _, Hkv, Smax, _ = k_cache.shape
    G = Hq // Hkv
    qf = q.reshape(B, Hkv, G, d).float()
    s = torch.einsum("bhgd,bhkd->bhgk", qf, k_cache.float()) * d ** -0.5
    s = torch.where(_decode_mask(index, Smax, window, q.device), s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgk,bhkd->bhgd", p, v_cache.float())
    return o.reshape(B, Hq, 1, d).to(v_cache.dtype)


def decode_attention_ref(q, k_cache, v_cache, index, *, window: int = 0,
                         kv_block: int = 256):
    """Prefix-skipping cached decode (the served ``torch`` tier).

    With ``window == 0`` only positions ``<= index`` are live, so the
    softmax covers the shortest power-of-two-of-``kv_block`` cache prefix
    that holds ``index`` instead of all of Smax. Picking the prefix reads
    ``index`` on the host. Rolling-window caches wrap, so they take the
    dense path; so does an ``index`` the host cannot read (a DTensor or a
    fake tensor, as the dry-run traces it): like the reference's traced
    index, it leaves the whole cache live."""
    B, Hq, _, d = q.shape
    _, Hkv, Smax, _ = k_cache.shape
    kb = min(kv_block, Smax) if kv_block else Smax
    if window or kb >= Smax or _unreadable(index):
        return decode_attention_dense_ref(q, k_cache, v_cache, index,
                                          window=window)
    idx = int(index)
    L = kb
    while L <= idx and L < Smax:
        L *= 2
    L = min(L, Smax)
    G = Hq // Hkv
    qf = q.reshape(B, Hkv, G, d).float()
    s = torch.einsum("bhgd,bhkd->bhgk", qf,
                     k_cache[:, :, :L].float()) * d ** -0.5
    s = torch.where(torch.arange(L, device=q.device) <= idx, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgk,bhkd->bhgd", p, v_cache[:, :, :L].float())
    return o.reshape(B, Hq, 1, d).to(v_cache.dtype)


def subnet_rmsnorm_ref(x, gamma_table, subnet_id, eps: float = 1e-5):
    """RMSNorm with the per-subnet gain row (SubnetNorm)."""
    gamma = take_row(gamma_table, subnet_id)
    xf = acc(x)
    y = xf * torch.rsqrt((xf * xf).mean(-1, keepdim=True) + eps)
    return (y * gamma.to(xf.dtype)).to(x.dtype)


def add_subnet_rmsnorm_ref(x, delta, gamma_table, subnet_id,
                           eps: float = 1e-5):
    """SubnetNorm with the pending residual add in front: ``(s, h)`` with
    ``s = x + delta`` (rounded to x's type) and ``h`` the norm of ``s``."""
    s = x + delta
    return s, subnet_rmsnorm_ref(s, gamma_table, subnet_id, eps=eps)
