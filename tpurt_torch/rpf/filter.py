"""Random Parameter Filtering: the per-pixel filter over a pixel batch
(port of tpurt/rpf/filter.py).

The sample buffer is an (H, W, S, 19) float32 tensor; each pixel gathers
its (box x box x S) window, builds a 3-sigma feature-clustered
neighborhood mask, z-normalizes, estimates the 96 pairwise mutual
informations from joint histograms, derives the alpha/beta dependency
weights, and blends its own S samples against the neighborhood with the
joint bilateral weight.  tpurt's ``vmap`` over pixels is the leading batch
dimension P of every tensor here.

Sample vector layout (custom/sd.h:21-59): [0:2]=pFilm, [2:5]=L rgb,
[5:7]=pLens (the random parameters), [7:19]=n0,p0,n1,p1.

Reference quirks kept, as tpurt keeps them (tpurt/rpf/filter.py:16-30):
- sigma_p = box_size // 4 with INTEGER division (rpf.cpp:531),
- sigma_c^2 = sigma_f^2 = seed^2 / (1 - W_r_c)^2 (:662-663),
- divide-by-zero -> 0 in z-normalization (ops.h:45-51),
- population (1/N) mean/stddev (ops.h:111-144), one pass: E[x^2] - m^2,
- bins = max(1, floor(sqrt(N))) with degenerate ranges dumping all mass
  in bin 0 (mi.cpp:5-20), natural-log MI clamped at 0,
- blending uses UNNORMALIZED neighborhood colors (rpf.cpp:692),
- neighborhood = own samples (unconditionally) + window samples passing
  the STRICT 3-sigma test on all 12 features vs the pixel's own stats,
- rejected rows are zeroed after normalization, before the blend,
- tpurt's fix of the reference's out-of-bounds D_c_fk read (rpf.cpp:466):
  D_c_fk = sum_l MI(f_k, c_l) (Sen & Darabi 2011, eq. 20),
- above MI_MAX_SAMPLES neighborhood rows, the MI estimate uses the own
  rows plus an evenly strided window subset.

The one-pass std matters: ``torch.std`` would return exactly 0 where the
one-pass form leaves a tiny positive value, and flip the strict test.

Numbers: the joint histograms are two batched float32 products
(``torch.bmm``) of 0/1 one-hot operands, so every count is an exact
integer, with or without TF32 (0 and 1 are exact in TF32's 10-bit
mantissa; counts stay far below 2^24).  The blend ``w @ colors`` is a
float32 ``bmm`` too; it rounds as float32 only with
``torch.backends.cuda.matmul.allow_tf32`` False, PyTorch's default, which
the port never changes.
"""

from __future__ import annotations

import math

import numpy as np
import torch

# column groups in the 19-vector
POS = slice(0, 2)
COL = slice(2, 5)
RND = slice(5, 7)
FEAT = slice(7, 19)
SD_LEN = 19

SIGMA_FC_SEED = 0.002  # rpf.cpp:533
MI_MAX_SAMPLES = 4096  # cap on the MI-estimation subset (see _filter_pixels)
# device memory one pixel chunk may use (the chunk is sized from it)
CHUNK_BYTES = 4 << 30


def _mi_pairs():
    """The 96 (a, b) column-index pairs whose MI the CF weights need."""
    f = list(range(7, 19))
    p = [0, 1]
    r = [5, 6]
    c = [2, 3, 4]
    pairs = []
    for fi in f:
        for rj in r:
            pairs.append((fi, rj))  # D_r_fk
    for fi in f:
        for pj in p:
            pairs.append((fi, pj))  # D_p_fk
    for ci in c:
        for rj in r:
            pairs.append((ci, rj))  # D_r_ck
    for ci in c:
        for pj in p:
            pairs.append((ci, pj))  # D_p_ck
    for ci in c:
        for fj in f:
            pairs.append((ci, fj))  # D_f_ck / D_c_fk
    return np.asarray(pairs, np.int32)


_PAIRS = _mi_pairs()
_O_R_FK = 0
_O_P_FK = 24
_O_R_CK = 48
_O_P_CK = 54
_O_F_CK = 60  # 36 entries: (color-major, feature-minor)
_N_RP = 60  # pairs [0, 60) pair a color/feature with pFilm/pLens
_RP_COLS = (0, 1, 5, 6)


def _masked_mean_std(x, mask, dim=1):
    """Population mean/std over masked rows (ops.h getMean/getStdDev)."""
    cnt = torch.clamp(mask.sum(dim=dim), min=1.0)
    m = (x * mask).sum(dim=dim) / cnt
    ex2 = (x * x * mask).sum(dim=dim) / cnt
    var = torch.clamp(ex2 - m * m, min=0.0)
    return m, torch.sqrt(var)


def _mutual_information(cols, mask, n, bins, b_max: int):
    """MI for all _PAIRS at each pixel of a batch.

    cols: (P, N, 19) normalized values; mask: (P, N, 1) float; n: (P,)
    counts; bins: (P,) int bin counts (= max(1, floor(sqrt(n))));
    b_max: upper bound on bins.  Returns (P, 96) MI values (natural log),
    mirroring mi.cpp:45-90.
    """
    p, n_rows = cols.shape[0], cols.shape[1]
    dev = cols.device
    # ranges over the masked set (degenerate -> all mass in bin 0)
    big = 3.4e38
    on = mask > 0
    vmin = torch.where(on, cols, big).amin(dim=1, keepdim=True)  # (P,1,19)
    vmax = torch.where(on, cols, -big).amax(dim=1, keepdim=True)
    rng = vmax - vmin
    binsf = bins.to(torch.float32)[:, None, None]
    scaled = torch.where(rng > 0, (cols - vmin) / torch.where(rng == 0, 1.0,
                                                              rng) * binsf,
                         0.0)
    idx = torch.minimum(torch.clamp(scaled.to(torch.int32), min=0),
                        (bins - 1).to(torch.int32)[:, None, None])  # (P,N,19)

    # masked one-hot over b_max bins: exact 0/1 float32 entries
    onehot = ((idx[..., None] == torch.arange(b_max, device=dev))
              .to(torch.float32) * mask[..., None])  # (P, N, 19, B)
    hist = onehot.sum(dim=1)  # (P, 19, B) marginals

    # joint histograms as two batched products over the row axis; the 96
    # pairs factor as (c u f) x (r u p) [60 pairs] + c x f [36 pairs]
    cf = onehot[:, :, 2:19].reshape(p, n_rows, 17 * b_max)
    rp = onehot[:, :, _RP_COLS].reshape(p, n_rows, 4 * b_max)
    joint1 = torch.bmm(cf.transpose(1, 2), rp).reshape(p, 17, b_max, 4,
                                                       b_max)
    joint2 = torch.bmm(onehot[:, :, 2:5].reshape(p, n_rows, 3 * b_max)
                       .transpose(1, 2),
                       onehot[:, :, 7:19].reshape(p, n_rows, 12 * b_max)
                       ).reshape(p, 3, b_max, 12, b_max)
    rp_map = np.full(19, -1, np.int64)
    rp_map[list(_RP_COLS)] = [0, 1, 2, 3]
    a1 = torch.as_tensor(_PAIRS[:_N_RP, 0] - 2, device=dev).long()
    b1 = torch.as_tensor(rp_map[_PAIRS[:_N_RP, 1]], device=dev)
    a2 = torch.as_tensor(_PAIRS[_N_RP:, 0] - 2, device=dev).long()
    b2 = torch.as_tensor(_PAIRS[_N_RP:, 1] - 7, device=dev).long()
    # advanced indices around a slice move to the front: (pairs, P, B, B)
    joint = torch.cat([joint1[:, a1, :, b1, :], joint2[:, a2, :, b2, :]],
                      dim=0).transpose(0, 1)  # (P, 96, B, B)

    a_idx = torch.as_tensor(_PAIRS[:, 0], device=dev).long()
    b_idx = torch.as_tensor(_PAIRS[:, 1], device=dev).long()
    total = torch.clamp(n.to(torch.float32), min=1.0)[:, None, None, None]
    p_xy = joint / total
    p_x = (hist[:, a_idx] / total[..., 0])[:, :, :, None]  # (P, 96, B, 1)
    p_y = (hist[:, b_idx] / total[..., 0])[:, :, None, :]  # (P, 96, 1, B)
    denom = p_x * p_y
    safe = (p_xy > 0) & (denom != 0)
    ratio = torch.where(safe, p_xy / torch.where(denom == 0, 1.0, denom), 1.0)
    mi = torch.where(safe, p_xy * torch.log(ratio), 0.0).sum(dim=(2, 3))
    # MI >= 0 mathematically; float32 log noise at degenerate histograms
    # gives ~-5e-8, which the 1e-12 guards of _cf_weights would blow up
    return torch.clamp(mi, min=0.0)


def _cf_weights(mi):
    """alpha_k (P,3), beta_k (P,12), W_r_c (P,) from (P, 96) MI values
    (rpf.cpp:416-487)."""
    p = mi.shape[0]
    d_r_fk = mi[:, _O_R_FK:_O_R_FK + 24].reshape(p, 12, 2).sum(-1)
    d_p_fk = mi[:, _O_P_FK:_O_P_FK + 24].reshape(p, 12, 2).sum(-1)
    d_r_ck = mi[:, _O_R_CK:_O_R_CK + 6].reshape(p, 3, 2).sum(-1)
    d_p_ck = mi[:, _O_P_CK:_O_P_CK + 6].reshape(p, 3, 2).sum(-1)
    cf = mi[:, _O_F_CK:_O_F_CK + 36].reshape(p, 3, 12)
    d_f_ck = cf.sum(-1)  # (P, 3) per color over features
    d_c_fk = cf.sum(1)  # (P, 12) per feature over colors (the UB fix)

    d_f_c = d_f_ck.sum(-1, keepdim=True)
    d_r_c = d_r_ck.sum(-1, keepdim=True)
    d_p_c = d_p_ck.sum(-1, keepdim=True)

    # the reference divides blindly; the tiny denominators only matter in
    # degenerate pixels where every MI is 0
    w_c_fk = d_c_fk / torch.clamp(d_f_c + d_r_c + d_p_c, min=1e-12)
    w_r_fk = d_r_fk / torch.clamp(d_r_fk + d_p_fk, min=1e-12)
    w_r_ck = d_r_ck / torch.clamp(d_r_ck + d_p_ck, min=1e-12)

    alpha_k = 1.0 - w_r_ck
    beta_k = (1.0 - w_r_fk) * w_c_fk
    w_r_c = w_r_ck.mean(-1)
    return alpha_k, beta_k, w_r_c


def _filter_pixels(own, window, window_valid, window_center, box_size: int,
                   b_max: int, mi_idx=None, sigma_seed=SIGMA_FC_SEED):
    """Filter a batch of P pixels (tpurt's ``_filter_pixel``, batched).

    own: (P, S, 19) the pixels' samples; window: (P, K, 19) all samples in
    each box (K = box^2 * S, INCLUDING the center pixel's); window_valid:
    (P, K) in-bounds flags; window_center: (K,) True for the center
    pixel's rows.  mi_idx: optional row subset (into the S+K neighborhood)
    for the mutual-information estimate when S+K > MI_MAX_SAMPLES; the
    blend still uses every neighborhood sample.  Returns (P, S, 3)
    filtered colors.
    """
    p, s = own.shape[0], own.shape[1]
    feats_own = own[:, :, FEAT]
    f_mean = feats_own.mean(dim=1, keepdim=True)
    f_ex2 = (feats_own * feats_own).mean(dim=1, keepdim=True)
    f_std = torch.sqrt(torch.clamp(f_ex2 - f_mean * f_mean, min=0.0))

    # 3-sigma clustering of non-center window samples (STRICT <)
    within = ((window[:, :, FEAT] - f_mean).abs() < 3.0 * f_std).all(dim=-1)
    cand_mask = window_valid & ~window_center & within

    # neighborhood = own samples + accepted candidates
    nb = torch.cat([own, window], dim=1)  # (P, S + K, 19)
    nb_mask = torch.cat([torch.ones((p, s), dtype=torch.bool,
                                    device=own.device), cand_mask],
                        dim=1).to(torch.float32)[:, :, None]
    n = nb_mask.sum(dim=(1, 2))

    # z-normalize over the neighborhood (div0 -> 0); rejected rows are
    # zeroed so that a rejected firefly cannot overflow against a tiny
    # std and poison the blend with inf * 0
    mu, sd = _masked_mean_std(nb, nb_mask, dim=1)
    mu, sd = mu[:, None, :], sd[:, None, :]
    nb_norm = torch.where(sd > 0, (nb - mu) / torch.where(sd == 0, 1.0, sd),
                          0.0)
    nb_norm = torch.where(nb_mask > 0, nb_norm, 0.0)
    own_norm = nb_norm[:, :s]

    # mutual information + dependency weights
    if mi_idx is not None:
        mi_rows = nb_norm[:, mi_idx]
        mi_mask = nb_mask[:, mi_idx]
        n_mi = mi_mask.sum(dim=(1, 2))
    else:
        mi_rows, mi_mask, n_mi = nb_norm, nb_mask, n
    bins = torch.clamp(torch.sqrt(n_mi).to(torch.int32), min=1)
    mi = _mutual_information(mi_rows, mi_mask, n_mi, bins, b_max)
    alpha_k, beta_k, w_r_c = _cf_weights(mi)

    # bilateral weights (rpf.cpp:637-678): integer-divided sigma_p, shared
    # sigma_c/sigma_f inflated by the color randomness
    sigma_p = float(box_size // 4)
    sigma_p2 = max(sigma_p * sigma_p, 1e-12)
    # a true division (a Python scalar over a tensor would be a
    # reciprocal and a product: two roundings)
    sigma_c2 = (torch.full_like(w_r_c, sigma_seed ** 2)
                / torch.clamp((1.0 - w_r_c) ** 2, min=1e-12))[:, None, None]
    sigma_f2 = sigma_c2

    dp = own_norm[:, :, None, POS] - nb_norm[:, None, :, POS]  # (P,S,N,2)
    dc = own_norm[:, :, None, COL] - nb_norm[:, None, :, COL]
    df = own_norm[:, :, None, FEAT] - nb_norm[:, None, :, FEAT]
    w = (torch.exp(-(dp * dp).sum(-1) / (2.0 * sigma_p2))
         * torch.exp(-(dc * dc * alpha_k[:, None, None, :]).sum(-1)
                     / (2.0 * sigma_c2))
         * torch.exp(-(df * df * beta_k[:, None, None, :]).sum(-1)
                     / (2.0 * sigma_f2)))
    w = w * nb_mask[:, None, :, 0]  # mask out rejected candidates

    # blend with UNNORMALIZED colors (rpf.cpp:682-717)
    sum_w = torch.clamp(w.sum(dim=-1, keepdim=True), min=1e-30)
    return torch.bmm(w, nb[:, :, COL].contiguous()) / sum_w  # (P, S, 3)


def filter_plan(box_size: int, s: int):
    """(mi_idx or None, b_max, bytes per pixel) for one box size and spp.

    The per-pixel size is tpurt's estimate (filter.py:350-360) of the
    dominant intermediates: the MI one-hot, the joint-histogram products
    and the bilateral pairwise differences (about 2.25 MB at box 7,
    8 spp)."""
    k = box_size * box_size * s
    n_full = s + k
    if n_full > MI_MAX_SAMPLES:
        # all S own rows + an evenly strided window subset
        stride = -(-k // (MI_MAX_SAMPLES - s))
        mi_idx = np.concatenate([np.arange(s),
                                 s + np.arange(0, k, stride)]).astype(np.int64)
        n_mi = len(mi_idx)
    else:
        mi_idx, n_mi = None, n_full
    b_max = int(math.floor(math.sqrt(n_mi))) + 1
    per_pixel = (n_mi * 19 * b_max * 6 + (19 * b_max) ** 2 * 4
                 + s * n_full * 17 * 4 * 3)
    return mi_idx, b_max, per_pixel


def apply_rpf_filter(buffer, box_size: int,
                     sigma_seed: float = SIGMA_FC_SEED):
    """One ApplyRPFFilter pass over the full sample buffer.

    buffer: (H, W, S, 19) float32 tensor.  Returns a new buffer with the
    filtered colors."""
    h, w, _, _ = buffer.shape
    bd = (box_size - 1) // 2
    padded = torch.nn.functional.pad(buffer, (0, 0, 0, 0, bd, bd, bd, bd))
    valid = torch.nn.functional.pad(
        torch.ones((h, w), dtype=torch.bool, device=buffer.device),
        (bd, bd, bd, bd))
    res = buffer.clone()
    res[..., COL] = filter_rows(padded, valid, box_size, sigma_seed)
    return res


def filter_rows(padded, valid, box_size: int,
                sigma_seed: float = SIGMA_FC_SEED):
    """The filtered colors (h, w, S, 3) of the pixels whose boxes lie in
    ``padded`` (h + 2 bd, w + 2 bd, S, 19), bd = box // 2, with
    ``valid`` (h + 2 bd, w + 2 bd) the rows and columns that hold image
    pixels (tpurt's per-pixel vmap over the padded buffer; the sharded
    filter passes a row block with its halos, parallel/mesh.py).  Pixels
    run in batches of as many as CHUNK_BYTES holds by ``filter_plan``'s
    estimate."""
    bd = (box_size - 1) // 2
    h, w = padded.shape[0] - 2 * bd, padded.shape[1] - 2 * bd
    s = padded.shape[2]
    dev = padded.device
    mi_idx, b_max, per_pixel = filter_plan(box_size, s)
    if mi_idx is not None:
        mi_idx = torch.as_tensor(mi_idx, device=dev)
    pixel_chunk = max(1, CHUNK_BYTES // per_pixel)
    # window offsets in (dy, dx) row-major order, then S samples each
    off = torch.arange(box_size, device=dev)
    dy = off.repeat_interleave(box_size)
    dx = off.repeat(box_size)
    center = ((dy == bd) & (dx == bd)).repeat_interleave(s)  # (K,)
    k = box_size * box_size * s

    n_pix = h * w
    out = torch.empty((n_pix, s, 3), dtype=torch.float32, device=dev)
    for start in range(0, n_pix, pixel_chunk):
        pid = torch.arange(start, min(start + pixel_chunk, n_pix), device=dev)
        ys, xs = pid // w, pid % w
        wy = ys[:, None] + dy[None, :]
        wx = xs[:, None] + dx[None, :]
        win = padded[wy, wx].reshape(-1, k, SD_LEN)  # (P, K, 19)
        val = valid[wy, wx].repeat_interleave(s, dim=1)  # (P, K)
        own = padded[ys + bd, xs + bd]  # (P, S, 19)
        out[start:start + pid.shape[0]] = _filter_pixels(
            own, win, val, center, box_size, b_max, mi_idx=mi_idx,
            sigma_seed=sigma_seed)
    return out.reshape(h, w, s, 3)
