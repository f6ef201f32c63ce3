"""A closed-loop ARCHES campaign worked out again from its specification.

The benchmark hands this module the same configuration and traffic that
build the program's ``CampaignSpec``, and it works out every slot from
them: the AI expert's weights from ``params_seed``, the switching tree from
its own profiling run and Gini fit, then the campaign itself, UE ``u`` of
slot ``s`` on key ``fold_in(fold_in(PRNGKey(seed), u), s)``.  It takes
nothing the program made.

Each slot: link adaptation from the last report plus OLLA, bits and QAM,
TDL fading, interference and noise, LS, both experts (the AI expert on
every UE, or on the first ``capacity`` UEs that select it), the switch,
equalization, the decision-directed SINR, the MIESM TB outcome, the KPMs;
then the KPM window, the tree and the switch register, which commits at
the slot boundary.  The numpy tree trainer is a frozen copy of the port's.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from arches_bench.reference import phy, prng

#: the policy's inputs, in the port's order (paper 4.3): 5 Aerial + 5 OAI KPMs
SELECTED_KPMS = ("phy_throughput", "mcs_index", "pdu_length", "ndi", "rsrp", "snr",
                 "mac_throughput", "lcid4_throughput", "mac_rx_bytes", "lcid4_rx_bytes")
_MAC_HEADER_BYTES, _RLC_HEADER_BYTES, _LCID4_FRACTION = 3, 2, 0.95
_OLLA_UP_DB, _OLLA_DOWN_DB, _OLLA_CLAMP_DB = 0.15, 1.35, 10.0


class Slot:
    """One multi-UE slot of the PUSCH receive chain for one configuration."""

    def __init__(self, cfg: phy.SlotConfig, ai_params: dict, *, gated: bool,
                 capacity: int | None, device):
        self.cfg, self.ai_params, self.gated, self.capacity = cfg, ai_params, gated, capacity
        self.device = torch.device(device)
        n_re = cfg.n_data_re()
        dev = self.device
        self.pilots = torch.as_tensor(phy.dmrs_sequence(cfg), device=dev)
        self.tbs = torch.as_tensor(phy.tbs_table(n_re), device=dev)
        self.ncb = torch.as_tensor(phy.n_code_blocks_table(n_re), device=dev)
        self.qm_by_mcs = torch.as_tensor(phy.QM_BY_MCS, device=dev)
        self.qm_idx_by_mcs = torch.as_tensor(phy.QM_INDEX_BY_MCS, device=dev)
        self.rate_by_mcs = torch.as_tensor(phy.RATE_BY_MCS, device=dev)
        self._params: dict = {}

    def params(self, ch: phy.ChannelConfig) -> tuple:
        if ch not in self._params:
            self._params[ch] = tuple(torch.as_tensor(np.asarray(v), device=self.device)
                                     for v in phy.channel_params(self.cfg, ch))
        return self._params[ch]

    def __call__(self, link: dict, modes: torch.Tensor, keys: torch.Tensor, p: tuple):
        """``(new link, outputs)`` for every UE; ``modes (U,)`` 0 = AI, 1 = MMSE."""
        cfg, dev = self.cfg, self.device
        n_ues = keys.shape[0]
        ks = prng.split(keys, 4)
        k_tx, k_ch, k_n, k_crc = ks[:, 0], ks[:, 1], ks[:, 2], ks[:, 3]
        mcs, mcs_margin = phy.select_mcs_index(link["reported_snr_db"]
                                               + link["olla_offset_db"])
        qm_idx = self.qm_idx_by_mcs[mcs]
        qm = self.qm_by_mcs[mcs].to(torch.float32)
        code_rate = self.rate_by_mcs[mcs]
        tbs = self.tbs[mcs].to(torch.float32)
        n_re = cfg.n_data_re()
        bits = prng.bernoulli(k_tx, 0.5, (n_re * 8,)).to(torch.uint8)
        syms_all = torch.stack([phy.modulate(bits[:, : n_re * q], q) for q in phy.QM_VALUES])
        ues = torch.arange(n_ues, device=dev)
        syms = syms_all[qm_idx, ues]
        fields = phy.simulate_channel(k_ch, cfg, p, n_ues)
        rx = phy.apply_channel(k_n, phy.map_slot_grid(cfg, syms, self.pilots), fields)
        h_ls = phy.ls_estimate(cfg, rx, self.pilots)

        # the expert bank and the switch
        h_mmse = phy.mmse_estimate(cfg, h_ls)
        is_ai = modes == 0
        overflow = torch.zeros_like(is_ai)
        if self.gated and self.capacity is not None:
            pos = torch.cumsum(is_ai.to(torch.int64), 0) - 1
            overflow = is_ai & (pos >= self.capacity)
            is_ai = is_ai & ~overflow
        h_sel = h_mmse
        if bool(is_ai.any()):
            rows = torch.nonzero(is_ai)[:, 0]
            h_sel = h_mmse.clone()
            h_sel[rows] = phy.ai_estimate(self.ai_params, h_ls[rows])

        x_hat = phy.mmse_equalize(cfg, rx, h_sel, fields["noise_var"])
        data_hat = phy.extract_data_re(cfg, x_hat)
        dd, sig = [], []
        for q in phy.QM_VALUES:
            nearest = phy.nearest_point(data_hat, q)
            dd.append(phy.ue_mean(torch.abs(data_hat - nearest) ** 2, -1))
            sig.append(phy.ue_mean(torch.abs(nearest) ** 2, -1))
        sinr_meas = torch.stack(sig)[qm_idx, ues] / torch.clamp(torch.stack(dd)[qm_idx, ues],
                                                                min=1e-9)
        genie_err = torch.abs(data_hat - syms) ** 2
        n = genie_err.shape[1] - genie_err.shape[1] % 12
        genie_sinr = 1.0 / torch.clamp(
            phy.ue_mean(genie_err[:, :n].reshape(n_ues, -1, 12), -1), min=1e-9)
        ok, tb_margin = phy.tb_success(genie_sinr, qm, code_rate, k_crc)
        ok_f = ok.to(torch.float32)
        slot_dur = cfg.slot_duration_s
        phy_bits = torch.where(ok, tbs / slot_dur, torch.zeros_like(tbs))
        rsrp = phy.ue_mean((torch.abs(h_sel) ** 2).reshape(n_ues, -1), -1)
        tb_bytes = tbs / 8.0
        mac = torch.clamp(tb_bytes - _MAC_HEADER_BYTES, min=0.0) * ok_f
        lcid4 = torch.clamp(mac - _RLC_HEADER_BYTES, min=0.0) * _LCID4_FRACTION
        step = torch.where(ok, torch.full_like(tbs, _OLLA_UP_DB),
                           torch.full_like(tbs, -_OLLA_DOWN_DB))
        snr_db = 10.0 * torch.log10(sinr_meas + 1e-9)
        new = {
            "reported_snr_db": snr_db,
            "olla_offset_db": torch.clamp(link["olla_offset_db"] + step, -_OLLA_CLAMP_DB,
                                          _OLLA_CLAMP_DB),
            "cum_phy_bits": link["cum_phy_bits"] + phy_bits * slot_dur,
            "cum_mac_bytes": link["cum_mac_bytes"] + mac,
            "cum_lcid4_bytes": link["cum_lcid4_bytes"] + lcid4,
            "slots": link["slots"] + 1,
        }
        elapsed = new["slots"].to(torch.float32) * slot_dur
        kpms = {
            "code_rate": code_rate, "sinr": snr_db, "qam_order": qm,
            "mcs_index": mcs.to(torch.float32), "tb_size": tbs * ok_f,
            "n_code_blocks": self.ncb[mcs].to(torch.float32) * ok_f,
            "pdu_length": tb_bytes * ok_f, "ndi": ok_f, "rsrp": rsrp,
            "phy_throughput": new["cum_phy_bits"] / elapsed,
            "snr": snr_db, "mac_throughput": new["cum_mac_bytes"] * 8.0 / elapsed,
            "lcid4_throughput": new["cum_lcid4_bytes"] * 8.0 / elapsed,
            "mac_rx_bytes": mac, "lcid4_rx_bytes": lcid4,
        }
        outputs = {"tb_ok": ok_f, "mcs": mcs.to(torch.int32),
                   "gated_overflow": overflow.to(torch.int32), "kpms": kpms,
                   "mcs_margin": mcs_margin, "tb_margin": tb_margin}
        return new, outputs


def init_link(n_ues: int, device) -> dict:
    def f(v):
        return torch.full((n_ues,), v, dtype=torch.float32, device=device)

    return {"reported_snr_db": f(20.0), "olla_offset_db": f(0.0), "cum_phy_bits": f(0.0),
            "cum_mac_bytes": f(0.0), "cum_lcid4_bytes": f(0.0),
            "slots": torch.zeros(n_ues, dtype=torch.int32, device=device)}


def _kpm_matrix(kpms: Mapping[str, torch.Tensor]) -> torch.Tensor:
    return torch.stack([kpms[n].to(torch.float32) for n in SELECTED_KPMS], dim=-1)


# -- the switching tree: profiling and the Gini trainer (frozen copy) -------------


def _gini(y: np.ndarray) -> float:
    if y.size == 0:
        return 0.0
    p = np.bincount(y, minlength=2) / y.size
    return float(1.0 - np.sum(p**2))


def _best_split(x: np.ndarray, y: np.ndarray):
    n, f = x.shape
    base = _gini(y)
    best = (0, np.inf, 0.0)
    for j in range(f):
        order = np.argsort(x[:, j], kind="stable")
        xs, ys = x[order, j], y[order]
        for i in np.nonzero(np.diff(xs) > 0)[0]:
            t = 0.5 * (xs[i] + xs[i + 1])
            w = ((i + 1) * _gini(ys[: i + 1]) + (n - i - 1) * _gini(ys[i + 1:])) / n
            if base - w > best[2] + 1e-12:
                best = (j, float(t), float(base - w))
    return best


def fit_tree(x: np.ndarray, y: np.ndarray, depth: int = 2, min_samples: int = 2):
    """Greedy Gini tree, complete and level-ordered: ``(feature, threshold,
    leaf_values)``; an unsplit node passes everything left (+inf)."""
    x = np.asarray(x, np.float64)
    y = np.asarray(y, np.int64)
    n_nodes = 2**depth - 1
    feature = np.zeros(n_nodes, np.int32)
    threshold = np.full(n_nodes, np.inf, np.float32)
    leaves = np.zeros(2**depth, np.float32)
    data = {0: (x, y)}
    for node in range(n_nodes):
        xx, yy = data.get(node, (x[:0], y[:0]))
        split = None
        if yy.size >= min_samples and _gini(yy) > 0:
            j, t, dec = _best_split(xx, yy)
            if np.isfinite(t) and dec > 0:
                split = (j, t)
        if split is None:
            data[2 * node + 1], data[2 * node + 2] = (xx, yy), (xx[:0], yy[:0])
        else:
            j, t = split
            feature[node], threshold[node] = j, t
            right = xx[:, j] > t
            data[2 * node + 1] = (xx[~right], yy[~right])
            data[2 * node + 2] = (xx[right], yy[right])
    for leaf in range(2**depth):
        yy = data.get(n_nodes + leaf, (x[:0], y[:0]))[1]
        if yy.size == 0:
            anc = (n_nodes + leaf - 1) // 2
            while anc > 0 and data.get(anc, (None, y[:0]))[1].size == 0:
                anc = (anc - 1) // 2
            yy = data.get(anc, (x, y))[1]
        leaves[leaf] = float(np.bincount(yy, minlength=2).argmax()) if yy.size else 0.0
    return feature, threshold, leaves


def tree_walk(x: torch.Tensor, tree: tuple, depth: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Each row's mode, and the least relative distance of a compared KPM
    from its node's threshold along the path (inf past pass-through nodes)."""
    feature, threshold, leaves = tree
    idx = torch.zeros(x.shape[0], dtype=torch.int64, device=x.device)
    margin = torch.full((x.shape[0],), float("inf"), device=x.device)
    for _ in range(depth):
        v, t = torch.gather(x, 1, feature[idx][:, None])[:, 0], threshold[idx]
        rel = torch.abs(v - t) / torch.clamp(torch.abs(t), min=1e-6)
        margin = torch.minimum(margin, torch.where(torch.isinf(t), margin, rel))
        idx = 2 * idx + 1 + (v > t).to(torch.int64)
    return leaves[idx - (2**depth - 1)].to(torch.int32), margin


def fit_policy(cfg: phy.SlotConfig, ai_params: dict, policy: Mapping, n_slots: int, device):
    """Profile both experts on the policy's labelled training scenario (key
    0; every UE on one expert, the two experts' runs side by side on the UE
    axis, whose UEs do not interact) and fit the tree on the KPM rows."""
    schedule = phy.SCENARIOS[policy["train_scenario"]](**dict(policy["train_scenario_args"]))
    n_train = policy.get("train_slots") or n_slots
    n = policy["train_ues"]
    slot = Slot(cfg, ai_params, gated=False, capacity=None, device=device)
    keys = prng.fold_in(prng.PRNGKey(0, device), torch.arange(n, device=device)).repeat(2, 1)
    modes = torch.tensor([0] * n + [1] * n, dtype=torch.int32, device=device)
    link = init_link(2 * n, device)
    rows = []
    for s in range(n_train):
        link, out = slot(link, modes, prng.fold_in(keys, s), slot.params(schedule(s)))
        rows.append(_kpm_matrix(out["kpms"]))
    feats = torch.stack(rows).cpu().numpy()  # (S, 2n, F): the AI runs, then the MMSE runs
    labels = np.repeat([0 if schedule(s).interference else 1 for s in range(n_train)], n)
    x = np.concatenate([feats[:, :n].reshape(-1, feats.shape[-1]),
                        feats[:, n:].reshape(-1, feats.shape[-1])])
    feature, threshold, leaves = fit_tree(x.astype(np.float32),
                                          np.concatenate([labels, labels]).astype(np.int32),
                                          depth=policy["depth"])
    return (torch.as_tensor(feature.astype(np.int64), device=device),
            torch.as_tensor(threshold, device=device), torch.as_tensor(leaves, device=device))


def run_campaign(config: Mapping, traffic: Mapping, seed: int, *, params_seed: int,
                 device, tree: tuple | None = None) -> dict[str, np.ndarray]:
    """The campaign's trajectory: ``modes``, ``decisions``, ``mcs``, ``tb_ok``,
    ``gated_overflow``, every KPM, and the margins by which each discrete
    outcome was decided (``mcs_margin`` in dB, ``tb_margin`` between the
    draw and the success probability, ``tree_margin`` relative to the
    threshold), each ``(S, U)`` numpy.  ``tree`` (this module's own fit for
    the same configuration) skips the fit."""
    cfg = phy.SlotConfig(n_prb=config["n_prb"])
    bank, switch, policy = config["bank"], config["switch"], config["policy"]
    n_ues, n_slots = traffic["n_ues"], traffic["n_slots"]
    ai_params = phy.init_ai_params(params_seed, bank["channels"], bank["n_res_blocks"], device)
    if tree is None:
        tree = fit_policy(cfg, ai_params, policy, n_slots, device)
    gated = bank["execution_mode"] == "gated"
    slot = Slot(cfg, ai_params, gated=gated, capacity=bank.get("gated_capacity"),
                device=device)
    schedule = phy.SCENARIOS[traffic["scenario"]](**dict(traffic.get("scenario_args", {})))
    dev = slot.device
    ue_keys = prng.fold_in(prng.PRNGKey(seed, dev), torch.arange(n_ues, device=dev))
    link = init_link(n_ues, dev)
    window = switch["window_slots"]
    ring = torch.zeros((n_ues, window, len(SELECTED_KPMS)), dtype=torch.float32, device=dev)
    active = torch.full((n_ues,), switch["default_mode"], dtype=torch.int32, device=dev)
    pending, streak = active.clone(), torch.zeros_like(active)
    rows: dict[str, list] = {}
    for s in range(n_slots):
        link, out = slot(link, active, prng.fold_in(ue_keys, s), slot.params(schedule(s)))
        # the KPM window: the newest min(window, s + 1) rows, newest first
        ring[:, s % window] = _kpm_matrix(out["kpms"])
        acc = torch.zeros_like(ring[:, 0])
        n_valid = min(window, s + 1)
        for off in range(1, n_valid + 1):
            acc = acc + ring[:, (s - off + 1) % window]
        mean = acc / torch.full_like(acc, float(n_valid))
        decide = switch["period_slots"] == 1 or s % switch["period_slots"] == 0
        raw, tree_margin = pending, torch.full((n_ues,), float("inf"), device=dev)
        if decide:
            raw, tree_margin = tree_walk(mean, tree, policy["depth"])
            streak = torch.where(raw == pending, torch.zeros_like(streak), streak + 1)
            commit = streak >= switch["hysteresis_slots"]
            pending = torch.where(commit, raw, pending)
            streak = torch.where(commit, torch.zeros_like(streak), streak)
        leaves = {"modes": active, "decisions": raw, "mcs": out["mcs"],
                  "tb_ok": out["tb_ok"], "gated_overflow": out["gated_overflow"],
                  "mcs_margin": out["mcs_margin"], "tb_margin": out["tb_margin"],
                  "tree_margin": tree_margin, **out["kpms"]}
        for k, v in leaves.items():
            rows.setdefault(k, []).append(v.detach().cpu().numpy())
        active = pending  # the boundary into slot s + 1
    return {k: np.stack(v) for k, v in rows.items()}
