"""TDL multipath channel + interference simulator (paper 6, Fig. 7).

The port of ``repro.phy.channel``'s traced path, batched over a leading UE
axis: one call simulates every UE of a slot from its ``(U, 2)`` keys.
``simulate_slot_channel`` is the host loop's form: one UE, a static
``ChannelConfig``, and with interference off it draws nothing for the
interferer, as the reference does.  The
AR(1) fading ``lax.scan`` of the reference is a 14-step loop.  Random
draws go through ``repro_torch.random`` with the reference's key
derivation (including the raw ``key + 1`` for imaginary parts), so the
same key gives the same fields up to float rounding.

Complex values are assembled from float32 real and imaginary planes: a
complex-by-real product or quotient in the reference is exact
componentwise scaling, and writing it that way keeps the two packages on
the same rounding.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from repro_torch import random as jr
from repro_torch.device import cached_const
from repro_torch.phy.nr import SlotConfig
from repro_torch.ue_reduce import ue_mean, ue_sum

_SQRT2 = float(np.float32(np.sqrt(2.0)))


@dataclasses.dataclass(frozen=True)
class TdlProfile:
    """Tapped-delay-line PDP (delays in seconds, powers in dB)."""

    delays_s: tuple[float, ...]
    powers_db: tuple[float, ...]
    doppler_hz: float = 10.0

    @property
    def rms_delay_spread_s(self) -> float:
        p = 10.0 ** (np.asarray(self.powers_db) / 10.0)
        p = p / p.sum()
        d = np.asarray(self.delays_s)
        mean = float((p * d).sum())
        return float(np.sqrt((p * (d - mean) ** 2).sum()))


INDOOR_LOS = TdlProfile(
    delays_s=(0.0, 30e-9, 70e-9, 150e-9, 310e-9),
    powers_db=(0.0, -6.0, -9.0, -12.0, -18.0),
    doppler_hz=5.0,
)

INDOOR_NLOS = TdlProfile(
    delays_s=(0.0, 50e-9, 120e-9, 200e-9, 430e-9, 700e-9),
    powers_db=(-1.0, 0.0, -3.0, -6.0, -9.0, -14.0),
    doppler_hz=15.0,
)


@dataclasses.dataclass(frozen=True)
class ChannelConfig:
    profile: TdlProfile = INDOOR_LOS
    snr_db: float = 25.0
    interference: bool = False
    inr_db: float = 12.0
    interference_prb_frac: float = 0.5
    interference_prb_start: float = 0.25
    interference_symbol_duty: float = 1.0
    dmrs_collision: bool = False


def _cplx(re: torch.Tensor, im: torch.Tensor) -> torch.Tensor:
    return torch.complex(re, im)


def _scale(z: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """Complex times real, componentwise."""
    return _cplx(z.real * s, z.imag * s)


def _unscale(z: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """Complex divided by real, componentwise."""
    return _cplx(z.real / s, z.imag / s)


def _abs2(z: torch.Tensor) -> torch.Tensor:
    return torch.abs(z) ** 2


def _complex_normal(key: torch.Tensor, shape: tuple[int, ...]) -> torch.Tensor:
    """``(normal(k) + 1j * normal(k + 1)) / sqrt(2)`` per key."""
    re = jr.normal(key, shape) / _SQRT2
    im = jr.normal(jr.add(key, 1), shape) / _SQRT2
    return _cplx(re, im)


def _tdl_constants(cfg: SlotConfig, profile: TdlProfile) -> tuple:
    """Per-(slot config, profile) constants on the host: tap amplitudes
    ``(T,)``, the AR(1) coefficients ``rho`` and ``sqrt(1 - rho**2)``, and the
    tap-delay steering matrix ``(n_sc, T)``."""
    powers = 10.0 ** (torch.tensor(profile.powers_db, dtype=torch.float32) / 10.0)
    amps = torch.sqrt(powers / powers.sum())
    # AR(1) time evolution, rho from the J0 small-argument expansion
    sym_duration = cfg.slot_duration_s / cfg.n_sym
    x = 2.0 * np.pi * profile.doppler_hz * sym_duration
    rho = torch.tensor(np.float32(np.clip(1.0 - x**2 / 4.0, 0.0, 1.0)))
    c = torch.sqrt(1.0 - rho**2)
    df = cfg.scs_khz * 1e3
    f = torch.arange(cfg.n_sc, dtype=torch.float32) * np.float32(df)
    tau = torch.tensor(profile.delays_s, dtype=torch.float32)
    phase = (f * np.float32(-2.0 * np.pi))[:, None] * tau[None, :]
    return amps, rho, c, _cplx(torch.cos(phase), torch.sin(phase))


def _freq_response(key: torch.Tensor, cfg: SlotConfig,
                   profile: TdlProfile) -> torch.Tensor:
    """One slot's CSI per UE: ``(U, n_ant, n_layers, n_sc, n_sym)``."""
    amps, rho, c, steering = cached_const(
        ("tdl", cfg, profile), key.device, lambda: _tdl_constants(cfg, profile))
    ks = jr.split(key)
    k_init, k_evo = ks[..., 0, :], ks[..., 1, :]
    shape0 = (cfg.n_ant, cfg.n_layers, len(profile.delays_s))
    g = _complex_normal(k_init, shape0)  # (U, ant, l, T)
    innov = _complex_normal(k_evo, (cfg.n_sym,) + shape0)  # (U, sym, ...)
    steps = []
    for m in range(cfg.n_sym):
        eps = innov[:, m]
        g = _cplx(g.real * rho + eps.real * c, g.imag * rho + eps.imag * c)
        steps.append(g)
    g_t = torch.stack(steps, dim=-1)  # (U, ant, l, T, sym)
    g_t = _scale(g_t, amps[:, None])
    return _tap_sum(steering, g_t).to(torch.complex64)


def _tap_sum(steering: torch.Tensor, g_t: torch.Tensor) -> torch.Tensor:
    """``einsum("st,ualtm->ualsm")`` tap by tap in a fixed order: each UE's
    response is the same bits in any batch (a GEMM's kernel, and its order,
    follows the batch)."""
    h = None
    for t in range(steering.shape[1]):
        term = steering[:, t, None] * g_t[..., t, None, :]
        h = term if h is None else h + term
    return h


def _normalize_power(h: torch.Tensor) -> torch.Tensor:
    """Per-UE unit mean power: ``h / sqrt(mean |h|^2 + 1e-12)``."""
    axes = tuple(range(1, h.ndim))
    p = ue_mean(_abs2(h), axes)
    s = torch.sqrt(p + 1e-12).reshape((-1,) + (1,) * (h.ndim - 1))
    return _unscale(h, s)


def _interference_mask(cfg: SlotConfig, ch: ChannelConfig) -> np.ndarray:
    """Frequency-selective occupied-PRB mask, (n_sc,) in {0,1}."""
    start_prb = int(round(ch.interference_prb_start * cfg.n_prb))
    n_hit = int(round(ch.interference_prb_frac * cfg.n_prb))
    sc = np.zeros(cfg.n_sc, np.float32)
    sc[start_prb * 12: min((start_prb + n_hit) * 12, cfg.n_sc)] = 1.0
    return sc


class ChannelParams(NamedTuple):
    """Per-slot channel knobs as tensors (stackable over slots and UEs)."""

    noise_var: torch.Tensor  # () float32
    interf_on: torch.Tensor  # () float32 in {0, 1}
    inr_lin: torch.Tensor  # () float32
    sc_mask: torch.Tensor  # (n_sc,) float32
    duty_full: torch.Tensor  # () float32 in {0, 1}
    base_sym_mask: torch.Tensor  # (n_sym,) float32
    p_rest: torch.Tensor  # () float32

    def to(self, device) -> "ChannelParams":
        return ChannelParams(*(x.to(device) for x in self))

    def at(self, s: int) -> "ChannelParams":
        """Slot ``s`` of slot-stacked params."""
        return ChannelParams(*(x[s] for x in self))


def _channel_params_np(cfg: SlotConfig, ch: ChannelConfig) -> tuple:
    duty = float(ch.interference_symbol_duty)
    base = np.zeros(cfg.n_sym, np.float32)
    if ch.dmrs_collision:
        base[list(cfg.dmrs_symbols)] = 1.0
        n_rest = cfg.n_sym - cfg.n_dmrs_sym
        p_rest = max(duty * cfg.n_sym - cfg.n_dmrs_sym, 0.0) / n_rest
    else:
        p_rest = duty
    return (
        np.float32(10.0 ** (-ch.snr_db / 10.0)),
        np.float32(1.0 if ch.interference else 0.0),
        np.float32(10.0 ** (ch.inr_db / 10.0)),
        _interference_mask(cfg, ch),
        np.float32(1.0 if duty >= 1.0 else 0.0),
        base,
        np.float32(p_rest),
    )


def channel_params(cfg: SlotConfig, ch: ChannelConfig,
                   device: torch.device | str = "cpu") -> ChannelParams:
    """Lower one ``ChannelConfig`` to per-slot tensors."""
    return ChannelParams(*(torch.as_tensor(np.asarray(v), device=device)
                           for v in _channel_params_np(cfg, ch)))


def channel_params_schedule(
    cfg: SlotConfig, schedule, n_slots: int, device: torch.device | str = "cpu"
) -> tuple[TdlProfile, ChannelParams]:
    """Stack a slot schedule into (profile, params with a leading slot axis)."""
    cfgs = [schedule(i) for i in range(n_slots)]
    if len({c.profile for c in cfgs}) > 1:
        raise ValueError("traced channel schedule requires a single TDL profile")
    leaves = zip(*(_channel_params_np(cfg, c) for c in cfgs))
    params = ChannelParams(*(torch.as_tensor(np.stack(v), device=device)
                             for v in leaves))
    return cfgs[0].profile, params


def channel_params_ue_schedule(
    cfg: SlotConfig, schedules, n_slots: int, device: torch.device | str = "cpu"
) -> tuple[TdlProfile, ChannelParams]:
    """Per-UE schedules -> params whose leaves lead with ``(n_slots, n_ues)``."""
    pairs = [channel_params_schedule(cfg, s, n_slots, device) for s in schedules]
    if len({profile for profile, _ in pairs}) > 1:
        raise ValueError("per-UE traced schedules require a single shared TDL profile")
    params = ChannelParams(*(torch.stack(ls, dim=1)
                             for ls in zip(*(p for _, p in pairs))))
    return pairs[0][0], params


def per_ue_params(p: ChannelParams, n_ues: int) -> ChannelParams:
    """One slot's params with an explicit leading ``(n_ues,)`` axis."""
    out = []
    for x, base_ndim in zip(p, (0, 0, 0, 1, 0, 1, 0)):
        if x.ndim == base_ndim:
            x = x.expand((n_ues,) + tuple(x.shape))
        out.append(x)
    return ChannelParams(*out)


def broadcast_params_to_ues(params: ChannelParams, n_ues: int) -> ChannelParams:
    """Give homogeneous ``(S, ...)`` params an explicit ``(S, U, ...)`` UE axis
    (views; params already per UE pass through), so every leaf can be split
    along the UEs."""
    if params.noise_var.ndim == 2:
        return params
    return ChannelParams(*(x[:, None].expand((x.shape[0], n_ues) + tuple(x.shape[1:]))
                           for x in params))


# -- multi-cell coupling (the topology layer) -----------------------------------
#
# A campaign laid out as ``n_cells`` cells couples them through the channel: a
# cell whose members see interference raises the noise floor of the other cells.
# The per-cell load is a sum of exact {0, 1} counts, so its value does not depend
# on how the UE axis is split into shards; across shards the partial counts are
# summed by one collective a slot (``reduce``).


class CellParams(NamedTuple):
    """Per-cell channel offsets and inter-cell coupling (replicated on every shard).

    ``noise_scale`` / ``inr_scale`` are linear per-cell multipliers of each
    member UE's thermal noise / interference power; cell ``c``'s noise floor
    is also multiplied by ``1 + coupling * mean load of the other cells``,
    where a cell's load is the share of its UEs with interference on this
    slot.  ``ues_per_cell`` is the global count, so shard-local code never
    needs the campaign's UE count.
    """

    noise_scale: torch.Tensor  # (n_cells,) float32
    inr_scale: torch.Tensor  # (n_cells,) float32
    coupling: torch.Tensor  # () float32
    ues_per_cell: torch.Tensor  # () float32

    def to(self, device) -> "CellParams":
        return CellParams(*(x.to(device) for x in self))


def cell_params(n_cells: int, ues_per_cell: int, *, noise_offsets_db=(),
                inr_offsets_db=(), coupling: float = 0.0,
                device: torch.device | str = "cpu") -> CellParams:
    """Lower per-cell dB offsets to ``CellParams`` (an empty tuple: no offset)."""
    def lin(offs, noun):
        if not len(offs):
            return torch.ones(n_cells, dtype=torch.float32, device=device)
        if len(offs) != n_cells:
            raise ValueError(f"{noun} has {len(offs)} entries for n_cells={n_cells}")
        return torch.as_tensor(
            (10.0 ** (np.asarray(offs, np.float64) / 10.0)).astype(np.float32), device=device)

    return CellParams(
        noise_scale=lin(noise_offsets_db, "noise_offsets_db"),
        inr_scale=lin(inr_offsets_db, "inr_offsets_db"),
        coupling=torch.tensor(np.float32(coupling), device=device),
        ues_per_cell=torch.tensor(np.float32(ues_per_cell), device=device),
    )


def apply_cell_coupling(p: ChannelParams, cell_of_ue: torch.Tensor, cells: CellParams, *,
                        reduce=None) -> ChannelParams:
    """Fold per-cell offsets and inter-cell leakage into one slot's per-UE params.

    ``p`` has ``(U,)`` leaves (``per_ue_params``; under sharding the shard's
    UEs) and ``cell_of_ue (U,)`` their global cell ids.  The load counts
    are summed with ``index_add_`` (exact integers in float32, so any order
    and any split of the UEs gives the same bits); ``reduce``, when given,
    sums the shards' ``(n_cells,)`` partial counts (the slot's one
    collective).  The rest follows the reference's float32 operations in
    its order.
    """
    n_cells = cells.noise_scale.shape[0]
    interf = p.interf_on.expand(cell_of_ue.shape).to(torch.float32)
    load = torch.zeros(n_cells, dtype=torch.float32, device=interf.device)
    load.index_add_(0, cell_of_ue.to(torch.int64), interf)
    if reduce is not None:
        load = reduce(load)
    mean_load = load / cells.ues_per_cell
    if n_cells > 1:
        other = (mean_load.sum() - mean_load) / (n_cells - 1)
    else:
        other = torch.zeros_like(mean_load)
    noise_mult = cells.noise_scale * (1.0 + cells.coupling * other)
    idx = cell_of_ue.to(torch.int64)
    return p._replace(noise_var=p.noise_var * noise_mult[idx],
                      inr_lin=p.inr_lin * cells.inr_scale[idx])


def simulate_slot_channel_traced(
    key: torch.Tensor, cfg: SlotConfig, profile: TdlProfile, p: ChannelParams
) -> dict[str, torch.Tensor]:
    """Every UE's slot channel from its ``(U, 2)`` key and per-UE params
    (``per_ue_params`` form).  Returns ``h (U, ant, l, sc, sym)``,
    ``noise_var (U,)`` and ``interference (U, ant, sc, sym)``."""
    ks = jr.split(key, 3)
    k_h, k_i, k_hi = ks[:, 0], ks[:, 1], ks[:, 2]
    h = _normalize_power(_freq_response(k_h, cfg, profile))

    rest = (jr.uniform(jr.fold_in(k_i, 7), (cfg.n_sym,))
            < p.p_rest[:, None]).to(torch.float32)
    mask = torch.maximum(p.base_sym_mask, rest)
    sym_mask = torch.where(p.duty_full[:, None] > 0, torch.ones_like(mask), mask)

    hi = _normalize_power(_freq_response(k_hi, cfg, profile)[:, :, 0])
    sym = _complex_normal(k_i, (cfg.n_sc, cfg.n_sym))  # (U, sc, sym)
    amp = torch.sqrt(p.noise_var * p.inr_lin) * p.interf_on  # (U,)
    re_mask = p.sc_mask[:, :, None] * sym_mask[:, None, :]  # (U, sc, sym)
    masked = _scale(sym, re_mask)[:, None]  # (U, 1, sc, sym)
    interference = _scale(hi, amp[:, None, None, None]) * masked
    return {"h": h, "noise_var": p.noise_var, "interference": interference}


def simulate_slot_channel(key: torch.Tensor, cfg: SlotConfig,
                          ch: ChannelConfig) -> dict[str, torch.Tensor]:
    """One UE's slot channel from its ``(2,)`` key and a static config:
    ``h (ant, l, sc, sym)``, ``noise_var ()`` and ``interference (ant, sc, sym)``.

    With interference on this is the traced simulation for one UE (its
    fields are the reference's host form up to float rounding, as the
    reference's own traced and static forms are); with it off the
    interferer is neither drawn nor computed and the field is zeros.  The
    per-config parameters are built once per device.
    """
    dev = key.device
    if ch.interference:
        p = cached_const(("channel_params", cfg, ch), dev,
                         lambda: _channel_params_np(cfg, ch))
        fields = simulate_slot_channel_traced(key[None], cfg, ch.profile,
                                              per_ue_params(ChannelParams(*p), 1))
        return {k: v[0] for k, v in fields.items()}
    k_h = jr.split(key, 3)[0]
    h = _normalize_power(_freq_response(k_h[None], cfg, ch.profile))[0]
    noise_var = cached_const(("noise_var", ch.snr_db), dev,
                             lambda: np.float32(10.0 ** (-ch.snr_db / 10.0)))
    interference = torch.zeros((cfg.n_ant, cfg.n_sc, cfg.n_sym), dtype=torch.complex64,
                               device=dev)
    return {"h": h, "noise_var": noise_var, "interference": interference}


def apply_channel(key: torch.Tensor, tx_grid: torch.Tensor,
                  fields: dict[str, torch.Tensor]) -> torch.Tensor:
    """RX grid ``y = H x + interference + AWGN`` per UE:
    ``tx_grid (U, l, sc, sym)`` -> ``(U, ant, sc, sym)``."""
    y = ue_sum(fields["h"] * tx_grid[:, None], 2)
    y = y + fields["interference"]
    noise = _complex_normal(key, tuple(y.shape[1:]))
    std = torch.sqrt(fields["noise_var"]).reshape(-1, 1, 1, 1)
    return y + _scale(noise, std)
