"""The reusable 3-stage telemetry-selection / policy-design process (paper 4).

Port of ``repro.core.methodology``.

Stage 1 -- *controlled perturbation*: inject calibrated complex AWGN into one
expert's output (Eq. 3) and record downstream KPMs as a function of the
intensity rho in [0, 2] (steps of 0.1 by default, as in the paper).

Stage 2 -- *monotonicity filtering*: keep KPMs whose mean response is
consistently monotonic in rho (Spearman rank correlation against rho).

Stage 3 -- *redundancy reduction*: Pearson correlation across the surviving
KPMs, average-linkage hierarchical clustering on ``1 - |r|``, cut at the
paper's 0.8 threshold, one representative per cluster (the paper keeps MCS
index for the link-adaptation cluster; priorities are configurable).

Stage 1 draws through ``repro_torch.random`` with the reference's key
derivation; stages 2 and 3 are the reference's numpy and scipy calls on the
host.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Mapping, Sequence

import numpy as np
import torch
from scipy.cluster.hierarchy import fcluster, leaves_list, linkage
from scipy.spatial.distance import squareform
from scipy.stats import spearmanr

from repro_torch import random as jr
from repro_torch.ue_reduce import ue_mean

# -- Stage 1: controlled perturbation -----------------------------------------


def perturb_estimate(h_est: torch.Tensor, rho, key: torch.Tensor) -> torch.Tensor:
    """Paper Eq. (3): ``h + rho * E[|h|] * CN(0, 1)``.

    ``key (..., 2)`` may carry leading axes that ``h_est`` shares (one
    perturbation per leading index, as the reference maps it over UEs);
    ``rho`` is then a float or a tensor with those leading axes.  The mean
    ``E[|h|]`` is taken over each perturbation's own entries.
    """
    lead = key.ndim - 1
    if tuple(h_est.shape[:lead]) != tuple(key.shape[:-1]):
        raise ValueError(f"keys {tuple(key.shape)} vs estimate {tuple(h_est.shape)}")
    ks = jr.split(key)
    kr, ki = ks[..., 0, :], ks[..., 1, :]
    shape = tuple(h_est.shape[lead:])
    axes = tuple(range(lead, h_est.ndim))
    scale = ue_mean(torch.abs(h_est), axes, keepdim=True) if axes else torch.abs(h_est)
    if isinstance(rho, torch.Tensor):  # per-perturbation intensities
        rho = rho.to(torch.float32).reshape(tuple(rho.shape) + (1,) * (h_est.ndim - rho.ndim))
    else:  # a Python float stays a kernel argument: nothing is uploaded
        rho = float(rho)
    # CN(0,1): unit-variance complex normal, each component variance 1/2
    s = rho * scale
    re = jr.normal(kr, shape) / _SQRT2 * s
    im = jr.normal(ki, shape) / _SQRT2 * s
    return h_est + torch.complex(re, im).to(h_est.dtype)


_SQRT2 = float(np.float32(np.sqrt(2.0)))

DEFAULT_RHOS = tuple(np.round(np.arange(0.0, 2.0 + 1e-9, 0.1), 3))


@dataclasses.dataclass
class SweepResult:
    rhos: np.ndarray  # (R,)
    kpm_names: tuple[str, ...]
    means: np.ndarray  # (R, K)
    ci95: np.ndarray  # (R, K)
    samples: np.ndarray  # (R, trials, K) raw per-trial values


def _summarize(rhos: np.ndarray, names: tuple[str, ...], samples: np.ndarray,
               n_trials: int) -> SweepResult:
    means = samples.mean(axis=1)
    std = samples.std(axis=1, ddof=1) if n_trials > 1 else np.zeros_like(means)
    ci95 = 1.96 * std / np.sqrt(max(n_trials, 1))
    return SweepResult(rhos=rhos, kpm_names=names, means=means, ci95=ci95,
                       samples=samples)


def sensitivity_sweep(
    eval_fn: Callable[[float, torch.Tensor], Mapping[str, float]],
    *,
    rhos: Sequence[float] = DEFAULT_RHOS,
    n_trials: int = 8,
    key: torch.Tensor | None = None,
) -> SweepResult:
    """Run ``eval_fn(rho, key) -> {kpm: value}`` over the rho grid; the key
    is split once per (rho, trial) as the reference splits it."""
    if key is None:
        key = jr.PRNGKey(0)
    names: tuple[str, ...] | None = None
    all_vals = []
    for rho in rhos:
        trial_vals = []
        for _ in range(n_trials):
            key, sub = jr.split(key)
            kpms = eval_fn(float(rho), sub)
            if names is None:
                names = tuple(kpms.keys())
            trial_vals.append([float(kpms[n]) for n in names])
        all_vals.append(trial_vals)
    assert names is not None
    return _summarize(np.asarray(rhos), names, np.asarray(all_vals), n_trials)


def sensitivity_sweep_batched(
    engine,
    schedule,
    *,
    rhos: Sequence[float] = DEFAULT_RHOS,
    n_trials: int = 8,
    slots_per_trial: int = 8,
    key: torch.Tensor | None = None,
) -> SweepResult:
    """Stage 1 on the batched slot engine: the rho grid rides the UE axis.

    Every ``(rho, trial)`` pair is one UE of a single ``slots_per_trial x
    (R*T)`` campaign (``BatchedPuschPipeline.run_perturbed``): each UE runs
    the MMSE-only pipeline with AWGN injected at its rho every slot.  A
    trial's sample is its UE's final-slot KPM vector, after
    ``slots_per_trial - 1`` slots of link-adaptation warm-up.  Returns a
    ``SweepResult`` shaped like the host harness's.
    """
    from repro_torch.core.telemetry import flatten_kpm_sources

    if key is None:
        key = jr.PRNGKey(0, engine.device)
    rhos_arr = np.asarray(list(rhos), np.float32)
    n_rhos = rhos_arr.shape[0]
    _, traj = engine.run_perturbed(schedule, np.repeat(rhos_arr, n_trials),
                                   n_slots=slots_per_trial, key=key)
    flat = flatten_kpm_sources(traj["kpms"])  # name -> (S, R*T)
    names = tuple(flat.keys())
    samples = np.stack(
        [flat[n][-1].to(torch.float64).cpu().numpy().reshape(n_rhos, n_trials)
         for n in names], axis=-1)  # final slot of each UE, as (R, T, K)
    return _summarize(rhos_arr, names, samples, n_trials)


# -- Stage 2: monotonicity filtering -------------------------------------------


def monotonicity_filter(
    sweep: SweepResult, *, min_abs_spearman: float = 0.8
) -> dict[str, float]:
    """KPM -> Spearman(rho, mean response); keeps ``|r| >= threshold``."""
    kept = {}
    for k, name in enumerate(sweep.kpm_names):
        r, _ = spearmanr(sweep.rhos, sweep.means[:, k])
        if np.isfinite(r) and abs(r) >= min_abs_spearman:
            kept[name] = float(r)
    return kept


# -- Stage 3: redundancy reduction ---------------------------------------------


@dataclasses.dataclass
class ClusterResult:
    names: tuple[str, ...]
    corr: np.ndarray  # (K, K) Pearson matrix
    labels: np.ndarray  # (K,) cluster ids
    representatives: tuple[str, ...]
    order: np.ndarray  # leaf order for block-diagonal display (paper Fig. 5)


def redundancy_reduction(
    samples: Mapping[str, np.ndarray],
    *,
    threshold: float = 0.8,
    representative_priority: Sequence[str] = ("mcs_index",),
) -> ClusterResult:
    """Pearson + average-linkage clustering at ``1 - threshold`` distance.

    ``samples`` maps KPM name -> 1-D array of per-slot observations (all the
    same length).  Within each cluster the representative is the first match
    in ``representative_priority``; otherwise the member with the largest
    mean |correlation| to its cluster (the most central one).
    """
    names = tuple(samples.keys())
    mat = np.stack([np.asarray(samples[n], np.float64) for n in names], axis=0)
    # guard: zero-variance KPMs correlate as 0 with everything
    std = mat.std(axis=1)
    std_safe = np.where(std > 0, std, 1.0)
    centered = (mat - mat.mean(axis=1, keepdims=True)) / std_safe[:, None]
    corr = centered @ centered.T / mat.shape[1]
    corr[std == 0, :] = 0.0
    corr[:, std == 0] = 0.0
    np.fill_diagonal(corr, 1.0)

    # sanitize: zero-variance / degenerate KPMs can leave non-finite entries
    corr = np.clip(np.nan_to_num(corr, nan=0.0, posinf=1.0, neginf=-1.0), -1.0, 1.0)
    np.fill_diagonal(corr, 1.0)

    dist = 1.0 - np.abs(corr)
    np.fill_diagonal(dist, 0.0)
    dist = np.clip((dist + dist.T) / 2, 0.0, 1.0)  # numerical symmetry
    z = linkage(squareform(dist, checks=False), method="average")
    labels = fcluster(z, t=1.0 - threshold, criterion="distance")

    # display order: traverse the dendrogram (block structure of Fig. 5)
    order = leaves_list(z)

    reps = []
    for c in sorted(set(labels)):
        members = [i for i in range(len(names)) if labels[i] == c]
        rep = None
        for p in representative_priority:
            if p in (names[i] for i in members):
                rep = p
                break
        if rep is None:
            centrality = [np.mean(np.abs(corr[i, members])) for i in members]
            rep = names[members[int(np.argmax(centrality))]]
        reps.append(rep)
    return ClusterResult(
        names=names,
        corr=corr,
        labels=labels,
        representatives=tuple(reps),
        order=order,
    )


def design_policy_inputs(
    aerial_samples: Mapping[str, np.ndarray],
    oai_samples: Mapping[str, np.ndarray],
    *,
    threshold: float = 0.8,
    always_include: Sequence[str] = ("phy_throughput",),
) -> tuple[tuple[str, ...], ClusterResult, ClusterResult]:
    """Full Stage-3 as the paper runs it: Aerial and OAI clustered separately,
    PHY throughput re-added afterwards (it is excluded from correlation due to
    its cumulative computation)."""
    aerial = redundancy_reduction(aerial_samples, threshold=threshold)
    oai = redundancy_reduction(oai_samples, threshold=threshold)
    selected = tuple(always_include) + aerial.representatives + oai.representatives
    # stable de-dup
    seen, final = set(), []
    for s in selected:
        if s not in seen:
            seen.add(s)
            final.append(s)
    return tuple(final), aerial, oai
