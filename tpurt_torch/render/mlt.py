"""Metropolis light transport: Kelemen-style primary-sample-space MLT over
the bidirectional path tracer (port of tpurt/render/mlt.py:
VectorSampler, n_dims_for, _strategy_pairs, make_mlt_eval and
render_mlt, with its chain_steps body as chain_step).

Reference analog: integrators/mlt.{h,cpp}: MLTSampler (mlt.h:53-105),
the bootstrap and the chain normalisation b (mlt.cpp:165-220), the
Metropolis chains splatting the current and the proposed state with the
Kelemen weights (:221-285) and the one-strategy evaluation L()
(:100-140) on ConnectBDPT.

Chains ARE wavefront lanes.  A chain's state is one row of a primary
sample matrix X (N, DIMS); bdpt's static dimension schedule fixes DIMS,
and a VectorSampler replays the rows through bdpt_radiance in its MLT
mode (``depth_select`` keeps one path depth per chain group, a per-lane
``s_select`` picks the strategy).  Each Metropolis step is one eager
wavefront: mutate X, evaluate, accept or reject, splat both states.

The small step is tpurt's: a whole-vector Gaussian with effSigma =
sigma * sqrt(n_since), n_since the steps since the chain's last accepted
move, so that a rejection streak widens the step with no acceptance
correction (tpurt's mlt.py:195-206).  pbrt keeps sigma constant; the
port is held to tpurt, and the widening is a fault both share (ROADMAP,
Queue 3).

Randomness: the bootstrap rows come from the port's Threefry
(sampling/threefry.py: ``split`` and ``uniform``), bit-equal to tpurt's
``jax.random`` draws under the same seed, so every per-depth
normalisation b_d equals tpurt's up to the renderer's rounding.  The
chains' seed choice and their large-step, proposal, normal and accept
draws come from a ``torch.Generator`` on the render device seeded from
the same per-depth Threefry key: not bit-equal to tpurt's (acceptance
makes a chain chaotic anyway, so chains are held statistically).
"""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import NamedTuple, Optional

import torch

from tpurt_torch.render.bdpt import bdpt_radiance
from tpurt_torch.sampling import threefry
from tpurt_torch.utils.stats import STATS

log = logging.getLogger("tpurt_torch.mlt")

# MLT's parameters with tpurt's defaults (mlt.py:135-149)
N_CHAINS = 1 << 14
N_BOOTSTRAP = 1 << 17


class VectorSampler(NamedTuple):
    """The sampler protocol over explicit primary-sample rows (N, DIMS)."""

    X: torch.Tensor
    res_x: int
    res_y: int
    spp: int = 1
    name: str = "pss"

    def lane_ctx(self, px, py, sidx):
        return None

    def dim(self, px, py, sidx, d: int, ctx=None):
        return self.X[:, d]

    def film_offset(self, px, py, sidx, ctx=None):
        """Dims 0 and 1 map onto the FULL film plane (mlt.cpp: the camera
        stream's first two samples choose the raster position)."""
        return self.X[:, 0] * self.res_x, self.X[:, 1] * self.res_y


def n_dims_for(max_depth: int, has_media: bool = False) -> int:
    """The length of bdpt's static dimension schedule + 1 strategy-select
    dim; media scenes use 5 walk dims a bounce."""
    dpb = 5 if has_media else 3
    t_max_v = max_depth + 2
    s_max_v = max_depth + 1
    bl = 5 + dpb * (t_max_v - 1)
    bc = bl + 5 + dpb * (s_max_v - 1)
    return bc + 3 * (t_max_v - 1) + 1


def _strategy_pairs(depth: int, max_depth: int):
    """The (s, t) pairs bdpt evaluates for this depth, in its loop
    order."""
    pairs = []
    for t in range(1, max_depth + 3):
        for s in range(0, max_depth + 2):
            if (s == 1 and t == 1) or s + t - 2 != depth:
                continue
            pairs.append((s, t))
    return pairs


def make_mlt_eval(job, depth: int, traverse):
    """eval(X) -> (value (N, 3), raster (N, 2)) for one path depth.

    As in tpurt, the raster of a lane whose selected strategy is t=1 is
    read from splat row ``t1_row``, its index in the loop order of the
    pairs; bdpt returns the s=0 strategy's row first, so that row holds
    the camera sample's raster and the light-tracing splats land there
    (a fault of tpurt's the port shares: ROADMAP, Queue 3)."""
    film = job.film
    n_strat = depth + 2
    pairs = _strategy_pairs(depth, job.cfg.max_depth)
    t1_row = next((i for i, (s, t) in enumerate(pairs) if t == 1), -1)

    def eval_x(X):
        n = X.shape[0]
        sampler = VectorSampler(X=X, res_x=film.width, res_y=film.height)
        zeros = torch.zeros(n, dtype=torch.int64, device=X.device)
        s_select = torch.clamp((X[:, -1] * n_strat).to(torch.int32),
                               max=n_strat - 1)
        out = bdpt_radiance(job.scene, sampler, job.camera, zeros, zeros,
                            zeros, job.cfg, traverse, crop_xy=(0, 0),
                            texture_eval=job.texture_eval,
                            depth_select=depth, s_select=s_select)
        k = len(pairs)
        sp = out["splat_p"].reshape(k, n, 2)
        sl = out["splat_L"].reshape(k, n, 3)
        value = sl.sum(dim=0)  # one strategy fires per lane
        raster = out["p_film_crop"]
        if t1_row >= 0:
            sel_t1 = s_select == pairs[t1_row][0]
            raster = torch.where(sel_t1[:, None], sp[t1_row], raster)
        return value, raster

    return eval_x


def _lum(c):
    return 0.212671 * c[:, 0] + 0.715160 * c[:, 1] + 0.072169 * c[:, 2]


@dataclasses.dataclass
class Chains:
    """One depth's Metropolis chains, a row each: the primary samples X,
    the current state's luminance y, raster and value, the steps since
    the chain's last accepted move, and the moves accepted so far."""

    X: torch.Tensor
    y: torch.Tensor
    raster: torch.Tensor
    val: torch.Tensor
    n_since: torch.Tensor
    n_accept: torch.Tensor

    @classmethod
    def start(cls, X, evaluate) -> "Chains":
        """Chains at the rows X, evaluated by ``evaluate``."""
        val, raster = evaluate(X)
        return cls(X=X, y=_lum(val), raster=raster, val=val,
                   n_since=torch.ones(X.shape[0], dtype=torch.int32,
                                      device=X.device),
                   n_accept=torch.zeros((), dtype=torch.int64,
                                        device=X.device))


def chain_step(film, state, evaluate, ch: Chains, g: torch.Generator,
               sigma: float, p_large: float, w_scale: float,
               b_d: float) -> None:
    """One Metropolis step of every chain (tpurt's chain_steps body,
    mlt.py:189-227): propose a large or a small step, evaluate it, splat
    both states with the Kelemen weights and accept or reject; updates
    ``ch`` and the film state in place."""
    n, dev = ch.X.shape[0], ch.X.device
    large = torch.rand(n, generator=g, device=dev) < p_large
    Xl = torch.rand(ch.X.shape, generator=g, device=dev)
    # MLTSampler's lazy small step reduces, when every dim is read every
    # iteration (bdpt's static schedule), to a whole-vector Gaussian with
    # effSigma = sigma * sqrt(n_since)
    eff_sigma = sigma * torch.sqrt(ch.n_since.to(torch.float32))
    Xs = torch.remainder(ch.X + eff_sigma[:, None] * torch.randn(
        ch.X.shape, generator=g, device=dev), 1.0)
    Xp = torch.where(large[:, None], Xl, Xs)
    val_p, raster_p = evaluate(Xp)
    yp = _lum(val_p)
    a = torch.clamp(yp / torch.clamp(ch.y, min=1e-20), max=1.0)
    a = torch.where(ch.y <= 0, 1.0, a)
    # the Kelemen weights' denominators use the per-depth b_d
    w_new = w_scale * (a + large.float()) / (yp / b_d + p_large)
    w_old = w_scale * (1.0 - a) / (ch.y / b_d + p_large)
    film.add_splats(state, raster_p, val_p * w_new[:, None])
    film.add_splats(state, ch.raster, ch.val * w_old[:, None])
    accept = torch.rand(n, generator=g, device=dev) < a
    ch.X = torch.where(accept[:, None], Xp, ch.X)
    ch.y = torch.where(accept, yp, ch.y)
    ch.raster = torch.where(accept[:, None], raster_p, ch.raster)
    ch.val = torch.where(accept[:, None], val_p, ch.val)
    ch.n_since = torch.where(accept, 1, ch.n_since + 1)
    ch.n_accept = ch.n_accept + accept.sum()


def _generator(key, device) -> torch.Generator:
    """A torch.Generator on ``device`` seeded from a Threefry key."""
    g = torch.Generator(device=device)
    g.manual_seed((key[0] << 32) | key[1])
    return g


def render_mlt_job(job, params, quick: bool = False, traverse=None,
                   n_chains: Optional[int] = None,
                   n_bootstrap: Optional[int] = None,
                   stats: Optional[dict] = None):
    """The MLT pipeline on a built job (tpurt's render_mlt, mlt.py:135-283):
    the bootstrap, then the per-depth Metropolis chains.  ``params``: the
    scene's Integrator parameters (maxdepth, mutationsperpixel, sigma,
    largestepprobability, seed).  ``n_chains``: lanes a chain step; the
    reference's 1,000 chains become many short chains (tpurt's 2^14), and
    a card is full only with far more (chip_smoke runs 2^20).
    ``n_chains`` and ``n_bootstrap`` default to N_CHAINS and N_BOOTSTRAP,
    read at the call.  Fills ``stats`` (when given) with the bootstrap's
    and the chains' seconds, b per depth and each depth's chains, steps
    and acceptance.  Returns the (H, W, 3) image."""
    from tpurt_torch.kernels.traverse import traverse_wide

    traverse = traverse or traverse_wide
    n_chains = n_chains or N_CHAINS
    n_bootstrap = n_bootstrap or N_BOOTSTRAP
    max_depth = params.find_one_int("maxdepth", 5)
    mpp = params.find_one_int("mutationsperpixel", 100)
    sigma = params.find_one_float("sigma", 0.01)
    p_large = params.find_one_float("largestepprobability", 0.3)
    if quick:
        mpp = max(1, mpp // 16)
    film = job.film
    dev = job.scene.geo.device
    dims = n_dims_for(max_depth, has_media=job.scene.has_media)
    depths = list(range(max_depth + 1))
    evals = {d: make_mlt_eval(job, d, traverse) for d in depths}
    stats = {} if stats is None else stats
    state = film.initial_state(dev, splats=True)

    # ---- the bootstrap: per-depth normalisation and chain seeds
    # (mlt.cpp:165); the image scales linearly with the b_d estimates, so
    # the bootstrap is large ----
    t0 = time.time()
    key = threefry.key(params.find_one_int("seed", 0))
    b_per_depth, boot_x, boot_y = {}, {}, {}
    for d in depths:
        key, k = threefry.split(key)
        X = threefry.uniform(k, (n_bootstrap, dims), device=dev)
        val, _ = evals[d](X)
        boot_x[d], boot_y[d] = X, _lum(val)
        b_per_depth[d] = float(boot_y[d].mean())
    b = sum(b_per_depth.values())
    stats.update(bootstrap_s=time.time() - t0, b_per_depth=b_per_depth,
                 depths={})
    if b <= 0:
        log.warning("MLT bootstrap found no light-carrying paths")
        return film.to_image(state)
    log.info("MLT bootstrap: b=%g per-depth=%s", b,
             {d: round(v, 6) for d, v in b_per_depth.items()})

    t0 = time.time()
    total_mutations = mpp * film.width * film.height
    for d in depths:
        mutations_d = int(total_mutations * (b_per_depth[d] / b))
        if mutations_d == 0:
            continue
        chains = min(n_chains, max(256, mutations_d))
        steps = max(1, mutations_d // chains)
        # each mutation of this group deposits I^(depth)/n_pixels in
        # expectation (the Kelemen weights carry 1/b_d), so the group is
        # scaled by n_pixels / its own mutation count
        w_scale = film.width * film.height / (chains * steps)
        b_d = b_per_depth[d]
        # chain seeds ~ the bootstrap luminance (mlt.cpp:213)
        key, k = threefry.split(key)
        g = _generator(k, dev)
        cdf = torch.cumsum(boot_y[d].double(), dim=0)
        u = torch.rand(chains, generator=g, device=dev, dtype=torch.float64)
        idx = torch.clamp(torch.searchsorted(cdf, u * cdf[-1], right=True),
                          max=n_bootstrap - 1)
        ch = Chains.start(boot_x[d][idx], evals[d])
        for _ in range(steps):
            chain_step(film, state, evals[d], ch, g, sigma, p_large,
                       w_scale, b_d)
        n_accept = int(ch.n_accept)
        acc = n_accept / max(chains * steps, 1)
        STATS.counter("MLT/Mutations proposed", chains * steps)
        STATS.counter("MLT/Mutations accepted", n_accept)
        stats["depths"][d] = dict(chains=chains, steps=steps,
                                  acceptance=acc)
        log.info("MLT depth %d: %d chains x %d steps (acceptance %.1f%%)",
                 d, chains, steps, 100.0 * acc)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    stats["chains_s"] = time.time() - t0
    log.info("MLT chains: %.1fs", stats["chains_s"])
    # the per-depth w_scale completes the normalisation (unlike the
    # reference's WriteImage(b / mutationsPerPixel), mlt.cpp:285)
    return film.to_image(state, splat_scale=1.0)


def render_mlt(sd, device="cuda", quick: bool = False, crop_override=None,
               traverse=None, n_chains: Optional[int] = None,
               n_bootstrap: Optional[int] = None,
               stats: Optional[dict] = None, spectrum: str = "rgb"):
    """Build the job of ``sd`` on ``device`` and render it through MLT;
    returns (image, job).  ``spectrum`` "sampled": the bdpt evaluations
    carry 60 bins and deposit RGB, from which the chains take their scalar
    contribution."""
    from tpurt_torch.render.driver import build_job

    job = build_job(sd, device, quick=quick, crop_override=crop_override,
                    spectrum=spectrum)
    img = render_mlt_job(job, sd.integrator_params, quick=quick,
                         traverse=traverse, n_chains=n_chains,
                         n_bootstrap=n_bootstrap, stats=stats)
    return img, job
