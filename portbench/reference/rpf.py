"""The reference's RPF filter: one pass of Random Parameter Filtering (Sen
and Darabi 2012, "On Filtering the Noise from the Random Parameters in
Monte Carlo Rendering", ACM TOG 31(3)) over a pixel's box, as
RayTracer-RPF's ``custom/rpf.cpp`` (ApplyRPFFilter, :497-733) computes it
for one box size, written per pixel from the paper's steps:

1. the pixel's own samples give the mean and the (population, one-pass)
   standard deviation of the 12 scene features; a sample of another pixel
   of the box joins the neighbourhood when every feature lies strictly
   within 3 deviations of that mean (rpf.cpp:552-583);
2. the neighbourhood (the own samples and the joined ones) is normalised
   to zero mean and unit deviation per column, a column of no deviation
   to 0 (ops.h:45-51);
3. mutual information between the columns, from joint histograms of
   floor(sqrt(n)) bins over each column's range (mi.cpp): of each feature
   and each colour channel with the random parameters (the lens sample)
   and with the film position, and of each colour channel with each
   feature (the paper's eq. 20 for D^c_{f,k});
4. the dependencies (paper eqs. 11-16, first iteration): alpha_k =
   1 - W^r_{c,k}, beta_k = W^c_{f,k} (1 - W^r_{f,k}), and the colour's
   own dependency W^r_c, the mean of W^r_{c,k};
5. the bilateral weight of neighbour j for own sample i: exp(-|dp|^2 /
   (2 sigma_p^2)) exp(-sum_k alpha_k dc_k^2 / (2 sigma_c^2)) exp(-sum_k
   beta_k df_k^2 / (2 sigma_f^2)) over the normalised columns, sigma_p =
   box // 4 (an integer division, rpf.cpp:531), sigma_c^2 = sigma_f^2 =
   0.002^2 / (1 - W^r_c)^2 (rpf.cpp:533, :662-663);
6. the filtered colour of sample i: the weighted mean of the
   neighbourhood's colours as they were before normalising (rpf.cpp:692).

The pixel's value is the mean of its samples' filtered colours (pbrt's
box filter of radius 0.5 puts every sample in its own pixel alone).
``dtype`` is the precision of steps 1-6 (the control computes them in
bfloat16).
"""

from __future__ import annotations

import torch

POS, COL, FEAT = slice(0, 2), slice(2, 5), slice(7, 19)
SIGMA_SEED = 0.002


def _mean_std(x, m):
    """Population mean and one-pass deviation of x (P, N, C) over rows
    with m (P, N, 1) = 1."""
    cnt = m.sum(1).clamp(min=1)
    mu = (x * m).sum(1) / cnt
    var = ((x * x * m).sum(1) / cnt - mu * mu).clamp(min=0)
    return mu, torch.sqrt(var)


def _mi(x, m, n):
    """Mutual information (natural log) of the column pairs of x (P, N,
    19) over rows m: a dict (a, b) -> (P,) for the pairs the weights
    need."""
    p_ = x.shape[0]
    bins = torch.sqrt(n).long().clamp(min=1)  # (P,)
    on = m[..., 0] > 0
    big = torch.finfo(x.dtype).max
    lo = torch.where(on[..., None], x, big).amin(1, keepdim=True)
    hi = torch.where(on[..., None], x, -big).amax(1, keepdim=True)
    rng = hi - lo
    bf = bins.to(x.dtype)[:, None, None]
    scaled = torch.where(rng > 0, (x - lo) / torch.where(rng > 0, rng, 1.0)
                         * bf, 0.0)
    idx = torch.minimum(scaled.long().clamp(min=0),
                        (bins - 1)[:, None, None])  # (P, N, 19)
    nb = int(bins.max())
    w = on.double()
    total = w.sum(1)  # (P,)

    def hist1(a):
        h = torch.zeros((p_, nb), dtype=torch.float64, device=x.device)
        return h.scatter_add_(1, idx[..., a], w) / total[:, None]

    def mi(a, b):
        j = torch.zeros((p_, nb * nb), dtype=torch.float64, device=x.device)
        j.scatter_add_(1, idx[..., a] * nb + idx[..., b], w)
        pxy = j.reshape(p_, nb, nb) / total[:, None, None]
        px, py = hist1(a)[:, :, None], hist1(b)[:, None, :]
        ok = (pxy > 0) & (px * py > 0)
        terms = torch.where(ok, pxy * torch.log(torch.where(ok, pxy, 1.0)
                                                / torch.where(ok, px * py,
                                                              1.0)), 0.0)
        return terms.sum((1, 2)).clamp(min=0)

    cols_f = range(7, 19)
    cols_c = range(2, 5)
    out = {}
    for a in list(cols_f) + list(cols_c):
        for b in (5, 6, 0, 1):
            out[(a, b)] = mi(a, b)
    for a in cols_c:
        for b in cols_f:
            out[(a, b)] = mi(a, b)
    return out


def filter_pixels(own, window, valid, center, box: int,
                  dtype=torch.float32):
    """Filtered value (P, 3) of P pixels: ``own`` (P, S, 19) their samples,
    ``window`` (P, K, 19) the samples of their boxes (the pixel's own
    among them, marked by ``center`` (K,)), ``valid`` (P, K) the rows
    inside the image."""
    own, window = own.to(dtype), window.to(dtype)
    p_, s = own.shape[0], own.shape[1]
    fm = own[..., FEAT].mean(1, keepdim=True)
    fsd = torch.sqrt(((own[..., FEAT] ** 2).mean(1, keepdim=True)
                      - fm * fm).clamp(min=0))
    near = ((window[..., FEAT] - fm).abs() < 3 * fsd).all(-1)
    join = valid & ~center[None] & near
    nb = torch.cat([own, window], 1)
    m = torch.cat([torch.ones((p_, s), dtype=torch.bool, device=own.device),
                   join], 1).to(dtype)[..., None]
    n = m.sum((1, 2)).double()
    mu, sd = _mean_std(nb, m)
    z = torch.where(sd[:, None] > 0, (nb - mu[:, None])
                    / torch.where(sd > 0, sd, 1.0)[:, None], 0.0)
    z = torch.where(m > 0, z, 0.0)
    mi = _mi(z, m, n)

    def total(a_cols, b_cols):
        return torch.stack([sum(mi[(a, b)] for b in b_cols) for a in a_cols],
                           -1)

    f, c = range(7, 19), range(2, 5)
    d_r_f, d_p_f = total(f, (5, 6)), total(f, (0, 1))  # (P, 12)
    d_r_c, d_p_c = total(c, (5, 6)), total(c, (0, 1))  # (P, 3)
    d_c_f = torch.stack([sum(mi[(a, b)] for a in c) for b in f], -1)
    d_f_c = total(c, f)  # (P, 3)
    w_c_f = d_c_f / (d_f_c.sum(-1) + d_r_c.sum(-1)
                     + d_p_c.sum(-1)).clamp(min=1e-12)[:, None]
    w_r_f = d_r_f / (d_r_f + d_p_f).clamp(min=1e-12)
    w_r_c = d_r_c / (d_r_c + d_p_c).clamp(min=1e-12)
    alpha = (1 - w_r_c).to(dtype)
    beta = ((1 - w_r_f) * w_c_f).to(dtype)
    wrc = w_r_c.mean(-1)
    sig_p2 = max(float(box // 4) ** 2, 1e-12)
    sig_c2 = (SIGMA_SEED ** 2 / ((1 - wrc) ** 2).clamp(min=1e-12)).to(dtype)
    zo = z[:, :s]
    dp = zo[:, :, None, POS] - z[:, None, :, POS]
    dc = zo[:, :, None, COL] - z[:, None, :, COL]
    df = zo[:, :, None, FEAT] - z[:, None, :, FEAT]
    e = ((dp * dp).sum(-1) / (2 * sig_p2)
         + (dc * dc * alpha[:, None, None]).sum(-1)
         / (2 * sig_c2)[:, None, None]
         + (df * df * beta[:, None, None]).sum(-1)
         / (2 * sig_c2)[:, None, None])
    wts = torch.exp(-e) * m[:, None, :, 0]
    col = nb[..., COL]
    out = (wts[..., None] * col[:, None]).sum(2) / wts.sum(-1).clamp(
        min=1e-30)[..., None]
    return out.float().mean(1)


def box_offsets(box: int):
    """The (dy, dx) of a box's pixels, row-major, and the centre's index."""
    bd = (box - 1) // 2
    offs = [(dy - bd, dx - bd) for dy in range(box) for dx in range(box)]
    return offs, offs.index((0, 0))
