"""Plain PyTorch versions of the WKV6 recurrence: the naive sequential loop
over time (the JAX package's ``kernels/rwkv6/ref.py``; the CPU's path and
the yardstick on the card), and the chunk algebra of the kernel's chunked
route (:func:`rwkv6_chunked_ref`, which the tests hold against the loop)."""
import torch


def rwkv6_ref(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              w: torch.Tensor, u: torch.Tensor, s0: torch.Tensor):
    """r, k, v, w: [B,H,T,K] fp32; u: [H,K]; s0: [B,H,K,K].
    Returns (out [B,H,T,K], s_final)."""
    s = s0
    outs = []
    for t in range(r.shape[2]):
        rt, kt, vt, wt = r[:, :, t], k[:, :, t], v[:, :, t], w[:, :, t]
        kv = kt[..., :, None] * vt[..., None, :]             # [B,H,K,K]
        outs.append(torch.einsum("bhk,bhkj->bhj", rt,
                                 u[None, :, :, None] * kv + s))
        s = wt[..., :, None] * s + kv
    if not outs:
        return torch.zeros_like(r), s
    return torch.stack(outs, dim=2), s


def _cumprod_excl(x: torch.Tensor, dim: int) -> torch.Tensor:
    """prod of the elements before each one along ``dim`` (1 for the
    first): products only."""
    ones = torch.ones_like(x.narrow(dim, 0, 1))
    return torch.cumprod(torch.cat([ones, x.narrow(dim, 0, x.shape[dim] - 1)],
                                   dim), dim)


def _revcumprod_excl(x: torch.Tensor, dim: int) -> torch.Tensor:
    """prod of the elements after each one along ``dim`` (1 for the
    last)."""
    return _cumprod_excl(x.flip(dim), dim).flip(dim)


def rwkv6_chunked_ref(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      w: torch.Tensor, u: torch.Tensor, s0: torch.Tensor,
                      chunk: int = 64, sub: int = 16):
    """The recurrence of :func:`rwkv6_ref` by the chunked route's algebra,
    for the tests.  With ``P(a, b) = prod_{a < s <= b} w_s`` (1 if empty),
    a chunk ``c .. c+L-1`` entered with state S gives

        out_t = (r_t * P(c-1, t-1)) . S
              + sum_{c <= s < t} (sum_i r_t[i] k_s[i] P(s, t-1)[i]) v_s
              + (sum_i r_t[i] u[i] k_t[i]) v_t
        S'    = diag(P(c-1, c+L-1)) S + sum_s (k_s * P(s, c+L-1))^T v_s

    with every factor a product of decays (no logarithm, no division, so
    w = 0 gives exact zeros).  As in the kernel, a chunk is cut into
    sub-chunks of ``sub`` positions: inside one the pairwise factors are
    products over a mask, across two ``P(s, t-1)`` is split at the
    sub-chunk boundaries into a suffix product on ``k_s``, the decays of the
    sub-chunks between and a prefix product on ``r_t``.  A partial last
    chunk is padded with ``w = 1`` and zero r, k, v."""
    if chunk % sub:
        raise ValueError(f"chunk {chunk} is not a whole number of "
                         f"sub-chunks of {sub}")
    b, h, t, kd = r.shape
    ns = chunk // sub
    s = s0
    outs = []
    lower = torch.ones(sub, sub, dtype=torch.bool, device=r.device).tril(-1)
    for c0 in range(0, t, chunk):
        n = min(chunk, t - c0)
        pad = chunk - n

        def part(x, fill):
            x = x[:, :, c0:c0 + n]
            if pad:
                x = torch.cat([x, x.new_full((b, h, pad, kd), fill)], dim=2)
            return x.reshape(b, h, ns, sub, kd)
        rc, kc, vc, wc = part(r, 0.0), part(k, 0.0), part(v, 0.0), part(w, 1.0)
        pre = _cumprod_excl(wc, 3)            # P(b_m, t-1) inside a sub-chunk
        suf = _revcumprod_excl(wc, 3)         # P(s, e_j) inside a sub-chunk
        dec = wc.prod(dim=3)                  # [B,H,NS,K] sub-chunk decays
        before = _cumprod_excl(dec, 2)        # prod_{l < m} D_l
        after = _revcumprod_excl(dec, 2)      # prod_{l > m} D_l
        rt = rc * pre                         # r~
        kt = kc * suf                         # k~
        # the state's share: (r_t * P(c-1, t-1)) . S
        out = torch.einsum("bhmtk,bhkj->bhmtj", rt * before[:, :, :, None], s)
        # pairs across sub-chunks j < m
        a = rc.new_zeros(b, h, ns, sub, ns, sub)
        for m in range(ns):
            for j in range(m):
                between = dec[:, :, j + 1:m].prod(dim=2)        # [B,H,K]
                a[:, :, m, :, j] = torch.einsum(
                    "bhtk,bhk,bhsk->bhts", rt[:, :, m], between, kt[:, :, j])
        # pairs inside a sub-chunk, s < t: P(s, t-1) over the mask s < s' < t
        # wm[.., t, s', k] = w_s' for s' < t else 1; P(s, t-1) = prod_{s'>s}
        wm = torch.where(lower[:, :, None], wc[:, :, :, None],
                         torch.ones_like(wc[:, :, :, None]))
        pair = _revcumprod_excl(wm, 4)         # [B,H,NS,sub(t),sub(s),K]
        inner = torch.einsum("bhmtk,bhmtsk,bhmsk->bhmts", rc, pair, kc)
        inner = inner * lower
        bonus = torch.einsum("bhmtk,hk,bhmtk->bhmt", rc, u, kc)
        for m in range(ns):
            a[:, :, m, :, m] = inner[:, :, m] + torch.diag_embed(bonus[:, :, m])
        a = a.reshape(b, h, chunk, chunk)
        out = out.reshape(b, h, chunk, kd) + a @ vc.reshape(b, h, chunk, kd)
        outs.append(out[:, :, :n])
        # the state the next chunk starts from
        kfull = (kt * after[:, :, :, None]).reshape(b, h, chunk, kd)
        s = (dec.prod(dim=2)[..., None] * s
             + kfull.transpose(2, 3) @ vc.reshape(b, h, chunk, kd))
    if not outs:
        return torch.zeros_like(r), s
    return torch.cat(outs, dim=2), s
