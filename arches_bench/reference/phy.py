"""The PUSCH slot's physical layer in plain torch and numpy.

Frozen copies of the port's plain forms (``repro_torch.phy``: ``nr``,
``dmrs``, ``qam``, ``mcs``, ``link``, ``channel``, ``estimators``,
``equalizer``, ``scenario``, ``ai_estimator``), cut to what a closed-loop
campaign on one cell runs.  Where the program runs a kernel this module
runs the textbook form: the Wiener interpolation is four float32 matrix
products, the AI expert is ``conv2d``.  Both follow the precision that
``torch.backends`` allows, which is how the control runs them in TF32.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch
import torch.nn.functional as F

from arches_bench.reference import prng

N_SC_PER_PRB = 12
N_SYM_PER_SLOT = 14
_SQRT2 = float(np.float32(np.sqrt(2.0)))


@dataclasses.dataclass(frozen=True)
class SlotConfig:
    """One UL PUSCH slot: 30 kHz spacing, 14 symbols, DMRS type 1 (comb 2)
    on symbols 0, 5 and 10, 4 receive antennas, one layer."""

    n_prb: int = 106
    n_ant: int = 4
    n_layers: int = 1
    dmrs_symbols: tuple[int, ...] = (0, 5, 10)
    scs_khz: int = 30

    @property
    def n_sc(self) -> int:
        return N_SC_PER_PRB * self.n_prb

    @property
    def n_sym(self) -> int:
        return N_SYM_PER_SLOT

    @property
    def n_dmrs_sym(self) -> int:
        return len(self.dmrs_symbols)

    @property
    def n_pilot_sc(self) -> int:
        return self.n_sc // 2

    @property
    def slot_duration_s(self) -> float:
        return 1e-3 / (self.scs_khz // 15)

    @property
    def pilot_sc_indices(self) -> np.ndarray:
        return np.arange(0, self.n_sc, 2)

    def n_data_re(self) -> int:
        full = (N_SYM_PER_SLOT - self.n_dmrs_sym) * self.n_sc
        return full + self.n_dmrs_sym * (self.n_sc - self.n_pilot_sc)


_CONSTS: dict = {}


def const(key: tuple, device, build):
    """A constant built once on the host and kept on ``device``."""
    k = key + (torch.device(device),)
    if k not in _CONSTS:
        built = build()
        _CONSTS[k] = (tuple(torch.as_tensor(b).to(device) for b in built)
                      if isinstance(built, tuple) else torch.as_tensor(built).to(device))
    return _CONSTS[k]


def ue_sum(x: torch.Tensor, dim) -> torch.Tensor:
    """``x.sum(dim)`` as a fixed pairwise tree per output, as the port sums."""
    dims = tuple(sorted(d % x.ndim for d in ((dim,) if isinstance(dim, int) else dim)))
    rest = [d for d in range(x.ndim) if d not in dims]
    out_shape = [x.shape[d] for d in rest]
    y = x.permute(*rest, *dims).reshape(*out_shape, -1)
    n = y.shape[-1]
    width = 1 << max(n - 1, 0).bit_length()
    if width != n:
        y = torch.cat([y, y.new_zeros(*out_shape, width - n)], dim=-1)
    while y.shape[-1] > 1:
        half = y.shape[-1] // 2
        y = y[..., :half] + y[..., half:]
    return y[..., 0]


def ue_mean(x: torch.Tensor, dim) -> torch.Tensor:
    dims = (dim,) if isinstance(dim, int) else tuple(dim)
    count = 1
    for d in dims:
        count *= x.shape[d]
    return ue_sum(x, dims) / count


# -- DMRS and the resource grid (TS 38.211) -------------------------------------


def _gold_sequence(c_init: int, length: int) -> np.ndarray:
    nc = 1600
    x1 = np.zeros(nc + length + 31, np.int8)
    x2 = np.zeros(nc + length + 31, np.int8)
    x1[0] = 1
    for i in range(31):
        x2[i] = (c_init >> i) & 1
    for n in range(len(x1) - 31):
        x1[n + 31] = (x1[n + 3] + x1[n]) % 2
        x2[n + 31] = (x2[n + 3] + x2[n + 2] + x2[n + 1] + x2[n]) % 2
    return ((x1[nc: nc + length] + x2[nc: nc + length]) % 2).astype(np.int8)


@functools.lru_cache(maxsize=None)
def dmrs_sequence(cfg: SlotConfig, cell_id: int = 42) -> np.ndarray:
    """QPSK DMRS of slot 0, ``(n_dmrs_sym, n_pilot_sc)`` complex64."""
    seqs = []
    for sym in cfg.dmrs_symbols:
        c_init = ((14 * 0 + sym + 1) * (2 * cell_id + 1) * 2**17 + 2 * cell_id) % (2**31)
        bits = _gold_sequence(int(c_init), 2 * cfg.n_pilot_sc).astype(np.float32)
        seqs.append((1.0 - 2.0 * bits[0::2]) / np.sqrt(2.0)
                    + 1j * (1.0 - 2.0 * bits[1::2]) / np.sqrt(2.0))
    return np.stack(seqs).astype(np.complex64)


@functools.lru_cache(maxsize=None)
def _data_flat_idx(cfg: SlotConfig) -> np.ndarray:
    mask = np.ones((cfg.n_sc, cfg.n_sym), bool)
    for sym in cfg.dmrs_symbols:
        mask[cfg.pilot_sc_indices, sym] = False
    return np.nonzero(mask.reshape(-1))[0]


def map_slot_grid(cfg: SlotConfig, data: torch.Tensor, pilots: torch.Tensor) -> torch.Tensor:
    """``(U, n_data_re)`` symbols -> TX grid ``(U, 1, n_sc, n_sym)``."""
    dev = data.device
    flat = torch.zeros((data.shape[0], cfg.n_sc * cfg.n_sym), dtype=torch.complex64,
                       device=dev)
    flat[:, const(("data_idx", cfg), dev, lambda: _data_flat_idx(cfg))] = data
    grid = flat.reshape(data.shape[0], cfg.n_sc, cfg.n_sym)
    pilot_sc = const(("pilot_idx", cfg), dev, lambda: cfg.pilot_sc_indices)
    for i, sym in enumerate(cfg.dmrs_symbols):
        grid[:, pilot_sc, sym] = pilots[i]
    return grid[:, None]


def extract_data_re(cfg: SlotConfig, grid: torch.Tensor) -> torch.Tensor:
    flat = grid.reshape(grid.shape[:-2] + (-1,))
    return flat[..., const(("data_idx", cfg), grid.device, lambda: _data_flat_idx(cfg))]


def extract_pilot_re(cfg: SlotConfig, grid: torch.Tensor) -> torch.Tensor:
    pilot_sc = const(("pilot_idx", cfg), grid.device, lambda: cfg.pilot_sc_indices)
    return torch.stack([grid[..., pilot_sc, sym] for sym in cfg.dmrs_symbols], dim=-2)


# -- QAM (TS 38.211 5.1) -------------------------------------------------------

_NORM = {2: np.sqrt(2.0), 4: np.sqrt(10.0), 6: np.sqrt(42.0), 8: np.sqrt(170.0)}


def _gray_pam_levels(half: int) -> np.ndarray:
    m = 1 << half
    levels = np.arange(-(m - 1), m, 2, dtype=np.float64)
    return np.asarray([levels[code ^ (code >> 1)] for code in range(m)])


def constellation_np(qm: int) -> np.ndarray:
    half = qm // 2
    pam = _gray_pam_levels(half)
    pts = np.asarray([pam[lab >> half] + 1j * pam[lab & ((1 << half) - 1)]
                      for lab in range(1 << qm)])
    return (pts / _NORM[qm]).astype(np.complex64)


def modulate(bits: torch.Tensor, qm: int) -> torch.Tensor:
    groups = bits.reshape(bits.shape[:-1] + (-1, qm)).to(torch.int64)
    weights = const(("bit_weights", qm), bits.device,
                    lambda: np.asarray([1 << (qm - 1 - i) for i in range(qm)], np.int64))
    labels = (groups * weights).sum(dim=-1)
    return const(("constellation", qm), bits.device, lambda: constellation_np(qm))[labels]


def nearest_point(y: torch.Tensor, qm: int) -> torch.Tensor:
    """The nearest point: the closest PAM level on each of I and Q."""
    half = qm // 2
    m = 1 << half
    inv = np.zeros(m, np.int64)
    for code in range(m):
        inv[code ^ (code >> 1)] = code
    inv_t = const(("gray_inverse", half), y.device, lambda: inv)
    norm = float(_NORM[qm])

    def level_idx(x):
        return torch.clamp(torch.round((x * norm + (m - 1)) / 2.0), 0, m - 1).long()

    pts = const(("constellation", qm), y.device, lambda: constellation_np(qm))
    return pts[inv_t[level_idx(y.real)] * m + inv_t[level_idx(y.imag)]]


# -- MCS table (TS 38.214 Table 5.1.3.1-2) and the MIESM TB model --------------

MCS_TABLE = (
    (2, 120), (2, 193), (2, 308), (2, 449), (2, 602), (4, 378), (4, 434),
    (4, 490), (4, 553), (4, 616), (4, 658), (6, 466), (6, 517), (6, 567),
    (6, 616), (6, 666), (6, 719), (6, 772), (6, 822), (6, 873), (8, 682.5),
    (8, 711), (8, 754), (8, 797), (8, 841), (8, 885), (8, 916.5), (8, 948),
)
QM_VALUES = (2, 4, 6, 8)
QM_BY_MCS = np.asarray([q for q, _ in MCS_TABLE], np.int32)
RATE_BY_MCS = np.asarray([r / 1024.0 for _, r in MCS_TABLE], np.float32)
QM_INDEX_BY_MCS = np.asarray([QM_VALUES.index(q) for q, _ in MCS_TABLE], np.int64)
SNR_THRESHOLDS_DB = np.asarray(
    [float(10.0 * np.log10(2.0 ** (q * r / 1024.0) - 1.0) + 1.0) for q, r in MCS_TABLE])


def tbs_table(n_data_re: int) -> np.ndarray:
    return np.asarray([int(max(24, np.floor(n_data_re * q * (r / 1024.0) / 8.0) * 8 - 24))
                       for q, r in MCS_TABLE], np.int32)


def n_code_blocks_table(n_data_re: int) -> np.ndarray:
    out = []
    for t in tbs_table(n_data_re):
        b = int(t) + 24
        out.append(1 if b <= 8448 else int(np.ceil(b / (8448 - 24))))
    return np.asarray(out, np.int32)


def select_mcs_index(snr_db: torch.Tensor, backoff_db: float = 1.0
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """The highest MCS whose SNR threshold fits, and the distance in dB from
    the nearest threshold."""
    th = const(("snr_thresholds",), snr_db.device,
               lambda: SNR_THRESHOLDS_DB.astype(np.float32))
    x = snr_db.to(torch.float32)[..., None] - backoff_db
    n_eligible = (th <= x).sum(dim=-1)
    return torch.clamp(n_eligible - 1, min=0), torch.abs(x - th).amin(dim=-1)


def _logaddexp(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    amax = torch.maximum(a, b)
    delta = a - b
    return torch.where(torch.isnan(delta), a + b,
                       amax + torch.log1p(torch.exp(-delta.abs())))


def tb_success(sinr_data: torch.Tensor, qm: torch.Tensor, code_rate: torch.Tensor,
               key: torch.Tensor, margin: float = 0.05) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-UE TB outcome: one uniform per UE against a logistic success
    probability of the capped-capacity MIESM margin; and how far the draw
    lay from that probability."""
    qm_f = qm.to(torch.float32)
    cap = torch.log2(1.0 + sinr_data / 1.25)
    mi = -_logaddexp(-3.0 * cap, -3.0 * qm_f[:, None]) / 3.0
    margin_mi = ue_mean(mi, -1) / qm_f - (code_rate + margin)
    u, p_success = prng.uniform(key, ()), torch.sigmoid(margin_mi * 80.0)
    return u < p_success, torch.abs(u - p_success)


# -- TDL channel, interference and noise ------------------------------------------


@dataclasses.dataclass(frozen=True)
class TdlProfile:
    delays_s: tuple[float, ...]
    powers_db: tuple[float, ...]
    doppler_hz: float = 10.0


INDOOR_LOS = TdlProfile(delays_s=(0.0, 30e-9, 70e-9, 150e-9, 310e-9),
                        powers_db=(0.0, -6.0, -9.0, -12.0, -18.0), doppler_hz=5.0)


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


GOOD = ChannelConfig(snr_db=8.0)
POOR = ChannelConfig(snr_db=8.0, interference=True, inr_db=18.0, interference_prb_frac=0.5,
                     interference_symbol_duty=3.0 / 14.0, dmrs_collision=True)

#: the scenarios the benchmark's traffic names: ``schedule(**args)(slot)``
SCENARIOS = {
    "good": lambda: (lambda slot: GOOD),
    "poor": lambda: (lambda slot: POOR),
    "good_poor_good": lambda poor_start=100, poor_end=200: (
        lambda slot: POOR if poor_start <= slot < poor_end else GOOD),
}


def _cplx(re, im):
    return torch.complex(re, im)


def _scale(z, s):
    return _cplx(z.real * s, z.imag * s)


def _complex_normal(key, shape):
    return _cplx(prng.normal(key, shape) / _SQRT2, prng.normal(prng.add(key, 1), shape) / _SQRT2)


def _tdl_constants(cfg: SlotConfig, profile: TdlProfile) -> tuple:
    powers = 10.0 ** (torch.tensor(profile.powers_db, dtype=torch.float32) / 10.0)
    amps = torch.sqrt(powers / powers.sum())
    x = 2.0 * np.pi * profile.doppler_hz * (cfg.slot_duration_s / cfg.n_sym)
    rho = torch.tensor(np.float32(np.clip(1.0 - x**2 / 4.0, 0.0, 1.0)))
    c = torch.sqrt(1.0 - rho**2)
    f = torch.arange(cfg.n_sc, dtype=torch.float32) * np.float32(cfg.scs_khz * 1e3)
    tau = torch.tensor(profile.delays_s, dtype=torch.float32)
    phase = (f * np.float32(-2.0 * np.pi))[:, None] * tau[None, :]
    return amps, rho, c, _cplx(torch.cos(phase), torch.sin(phase))


def _freq_response(key, cfg: SlotConfig, profile: TdlProfile) -> torch.Tensor:
    """``(U, ant, layers, n_sc, n_sym)``: AR(1) tap fading over the symbols."""
    amps, rho, c, steering = const(("tdl", cfg, profile), key.device,
                                   lambda: _tdl_constants(cfg, profile))
    ks = prng.split(key)
    shape0 = (cfg.n_ant, cfg.n_layers, len(profile.delays_s))
    g = _complex_normal(ks[..., 0, :], shape0)
    innov = _complex_normal(ks[..., 1, :], (cfg.n_sym,) + shape0)
    steps = []
    for m in range(cfg.n_sym):
        eps = innov[:, m]
        g = _cplx(g.real * rho + eps.real * c, g.imag * rho + eps.imag * c)
        steps.append(g)
    g_t = _scale(torch.stack(steps, dim=-1), amps[:, None])
    h = None
    for t in range(steering.shape[1]):
        term = steering[:, t, None] * g_t[..., t, None, :]
        h = term if h is None else h + term
    return h.to(torch.complex64)


def _normalize_power(h: torch.Tensor) -> torch.Tensor:
    p = ue_mean(torch.abs(h) ** 2, tuple(range(1, h.ndim)))
    s = torch.sqrt(p + 1e-12).reshape((-1,) + (1,) * (h.ndim - 1))
    return _cplx(h.real / s, h.imag / s)


def channel_params(cfg: SlotConfig, ch: ChannelConfig) -> tuple:
    """``(noise_var, interf_on, inr_lin, sc_mask (n_sc,), duty_full,
    base_sym_mask (n_sym,), p_rest)`` of one slot, float32."""
    duty = float(ch.interference_symbol_duty)
    base = np.zeros(cfg.n_sym, np.float32)
    if ch.dmrs_collision:
        base[list(cfg.dmrs_symbols)] = 1.0
        p_rest = max(duty * cfg.n_sym - cfg.n_dmrs_sym, 0.0) / (cfg.n_sym - cfg.n_dmrs_sym)
    else:
        p_rest = duty
    start = int(round(ch.interference_prb_start * cfg.n_prb))
    n_hit = int(round(ch.interference_prb_frac * cfg.n_prb))
    sc = np.zeros(cfg.n_sc, np.float32)
    sc[start * 12: min((start + n_hit) * 12, cfg.n_sc)] = 1.0
    return (np.float32(10.0 ** (-ch.snr_db / 10.0)), np.float32(1.0 if ch.interference else 0.0),
            np.float32(10.0 ** (ch.inr_db / 10.0)), sc, np.float32(1.0 if duty >= 1.0 else 0.0),
            base, np.float32(p_rest))


def simulate_channel(key, cfg: SlotConfig, p: tuple, n_ues: int) -> dict:
    """Every UE's slot channel from ``(U, 2)`` keys and one slot's params."""
    noise_var, interf_on, inr_lin, sc_mask, duty_full, base_sym, p_rest = p
    ks = prng.split(key, 3)
    h = _normalize_power(_freq_response(ks[:, 0], cfg, INDOOR_LOS))
    rest = (prng.uniform(prng.fold_in(ks[:, 1], 7), (cfg.n_sym,)) < p_rest).to(torch.float32)
    mask = torch.maximum(base_sym, rest)
    sym_mask = torch.where(duty_full > 0, torch.ones_like(mask), mask)
    hi = _normalize_power(_freq_response(ks[:, 2], cfg, INDOOR_LOS)[:, :, 0])
    sym = _complex_normal(ks[:, 1], (cfg.n_sc, cfg.n_sym))
    amp = (torch.sqrt(noise_var * inr_lin) * interf_on).expand(n_ues)
    masked = _scale(sym, sc_mask[None, :, None] * sym_mask[:, None, :])[:, None]
    interference = _scale(hi, amp[:, None, None, None]) * masked
    return {"h": h, "noise_var": noise_var.expand(n_ues), "interference": interference}


def apply_channel(key, tx_grid: torch.Tensor, fields: dict) -> torch.Tensor:
    """``y = H x + interference + AWGN``: ``(U, 1, sc, sym)`` -> ``(U, ant, sc, sym)``."""
    y = ue_sum(fields["h"] * tx_grid[:, None], 2) + fields["interference"]
    noise = _complex_normal(key, tuple(y.shape[1:]))
    return y + _scale(noise, torch.sqrt(fields["noise_var"]).reshape(-1, 1, 1, 1))


# -- the receiver ------------------------------------------------------------------


def ls_estimate(cfg: SlotConfig, rx_grid: torch.Tensor, pilots: torch.Tensor) -> torch.Tensor:
    """``(U, ant, sc, sym)`` -> LS at the pilots ``(U, ant, n_dmrs_sym, n_pilot_sc)``."""
    num = extract_pilot_re(cfg, rx_grid) * torch.conj(pilots)
    den = torch.abs(pilots) ** 2 + 1e-12
    return torch.complex(num.real / den, num.imag / den)


@functools.lru_cache(maxsize=None)
def wiener_matrix(cfg: SlotConfig, rms_delay_spread_s: float = 100e-9,
                  noise_var: float = 1e-2) -> np.ndarray:
    """``W^T = (R_fp (R_pp + sigma^2 I)^-1)^T``, ``(n_pilot_sc, n_sc)`` complex64."""
    k = np.arange(cfg.n_sc)
    r = 1.0 / (1.0 + 2j * np.pi * rms_delay_spread_s * (k[:, None] - k[None, :])
               * cfg.scs_khz * 1e3)
    p = cfg.pilot_sc_indices
    w = r[:, p] @ np.linalg.inv(r[np.ix_(p, p)] + noise_var * np.eye(len(p)))
    return np.ascontiguousarray(w.T).astype(np.complex64)


def mmse_estimate(cfg: SlotConfig, h_ls: torch.Tensor) -> torch.Tensor:
    """Wiener interpolation as four float32 products:
    ``(U, ant, S, Np)`` -> ``(U, ant, 1, n_sc, S)``."""
    w = const(("wiener", cfg), h_ls.device, lambda: wiener_matrix(cfg))
    hr, hi, wr, wi = h_ls.real, h_ls.imag, w.real, w.imag
    out = torch.complex(hr @ wr - hi @ wi, hr @ wi + hi @ wr)
    return out.movedim(-2, -1)[:, :, None]


def _time_weights(cfg: SlotConfig) -> np.ndarray:
    anchors = np.asarray(cfg.dmrs_symbols, np.float64)
    w = np.zeros((cfg.n_sym, cfg.n_dmrs_sym))
    for i in range(cfg.n_sym):
        j = int(np.clip(np.searchsorted(anchors, i) - 1, 0, len(anchors) - 2))
        a = np.clip((i - anchors[j]) / (anchors[j + 1] - anchors[j]), 0.0, 1.0)
        w[i, j], w[i, j + 1] = 1.0 - a, a
    return w.astype(np.float32)


def mmse_equalize(cfg: SlotConfig, rx_grid: torch.Tensor, h_dmrs: torch.Tensor,
                  noise_var: torch.Tensor) -> torch.Tensor:
    """Linear interpolation in time, then MRC/MMSE over the antennas:
    ``(U, sc, sym)`` symbol estimates."""
    w = const(("time_weights", cfg), h_dmrs.device,
              lambda: torch.as_tensor(_time_weights(cfg)).to(torch.complex64))
    h = None
    for d in range(w.shape[1]):
        term = h_dmrs[..., d, None] * w[:, d]
        h = term if h is None else h + term
    h = h[:, :, 0]
    num = ue_sum(torch.conj(h) * rx_grid, 1)
    d = ue_sum(torch.abs(h) ** 2, 1) + noise_var.reshape(-1, 1, 1)
    return torch.complex(num.real / d, num.imag / d)


# -- the AI expert (residual CNN) --------------------------------------------------


def init_ai_params(seed: int, channels: int, n_res_blocks: int, device) -> dict:
    """He-initialised 3x3 weights drawn from ``seed`` as the port draws them."""
    keys = prng.split(prng.PRNGKey(seed, device), 3 + 2 * n_res_blocks)

    def he(k, o, i, scale=2.0):
        s = torch.sqrt(torch.tensor(scale / (i * 9), dtype=torch.float32, device=device))
        return prng.normal(k, (o, i, 3, 3)) * s

    def zeros(n):
        return torch.zeros(n, dtype=torch.float32, device=device)

    c = channels
    return {
        "stem_w": he(keys[0], c, 2), "stem_b": zeros(c),
        "up_w": he(keys[1], 2 * c, c), "up_b": zeros(2 * c),
        "head_w": he(keys[2], 2, c, scale=1e-4), "head_b": zeros(2),
        "res": [{"w1": he(keys[3 + 2 * r], c, c), "b1": zeros(c),
                 "w2": he(keys[4 + 2 * r], c, c, scale=0.2), "b2": zeros(c)}
                for r in range(n_res_blocks)],
    }


def _conv(x, w, b):
    return F.conv2d(x, w, padding="same") + b[:, None, None]


def ai_estimate(params: dict, h_ls: torch.Tensor) -> torch.Tensor:
    """Comb-2 baseline plus the residual CNN on each antenna's (pilot
    subcarrier x DMRS symbol) image: ``(U, ant, S, Np)`` -> ``(U, ant, 1, n_sc, S)``."""
    n_ues, n_ant, n_sym, n_p = h_ls.shape
    x = torch.stack([h_ls.real, h_ls.imag], dim=2).reshape(n_ues * n_ant, 2, n_sym, n_p)
    x = x.transpose(-1, -2)  # (N, 2, Np, S)
    nxt = torch.cat([x[..., 1:, :], x[..., -1:, :]], dim=-2)
    base = torch.stack([x, 0.5 * (x + nxt)], dim=-2).reshape(*x.shape[:-2], 2 * n_p, n_sym)
    h = _conv(x, params["stem_w"], params["stem_b"])
    for blk in params["res"]:
        h = h + _conv(torch.relu(_conv(h, blk["w1"], blk["b1"])), blk["w2"], blk["b2"])
    u = _conv(h, params["up_w"], params["up_b"])
    n, c2 = u.shape[:2]
    u = u.reshape(n, 2, c2 // 2, n_p, n_sym).movedim(1, 3).reshape(n, c2 // 2, 2 * n_p, n_sym)
    out = base + _conv(u, params["head_w"], params["head_b"])
    return torch.complex(out[:, 0], out[:, 1]).reshape(n_ues, n_ant, 1, 2 * n_p, n_sym)
