"""The PUSCH receive pipeline with the ARCHES expert bank (paper Fig. 2,
nodes 2a-2e): the single-UE host pipeline and the batched multi-UE engine.

Per slot:

  TX   link adaptation (previous slot's SNR + OLLA -> MCS/TBS) -> bits -> QAM
       -> grid + DMRS
  CH   TDL fading + interference + AWGN
  RX   LS -> expert bank {AI (CNN), MMSE (``mmse_interp``)} -> switch
       (``switch_select``) -> time interpolation + MMSE equalizer ->
       decision-directed SINR, MIESM TB outcome, OLLA
  KPM  per-slot Aerial + OAI telemetry

``PuschPipeline`` is one UE's chain for the host loop (``ArchesRuntime``):
link state and KPM assembly are Python floats on the host, the slot's
tensors live on the device, the AI expert is the eager convolution path and
the switch is the scalar kernel.  Each slot reads the measured SINR, the
RSRP and the TB outcome back to the host in one copy: that is the slot's one
synchronisation with the card, by design (link adaptation is host logic).

``BatchedPuschPipeline`` runs every UE of a slot at once (a leading UE axis
replaces the reference's ``vmap``; a Python slot loop over device-resident
tensors replaces its ``lax.scan``), with the AI expert (on the card one
``gated_expert`` launch with every UE selected, so each UE's estimate is
the same bits whatever the batch; the folded GEMMs on the CPU) and the
per-UE switch; under GATED the AI expert runs only on the UEs that select
it, through ``switch_scatter`` or the fused ``gated_expert`` kernel.
``run`` is the open-loop campaign (a declared mode grid);
``run_closed_loop`` decides each UE's next mode inside the loop through the
device policy and the switch register; ``run_perturbed`` is the
methodology's stage 1 (MMSE only, AWGN injected at a per-UE ``rho``).  PRNG
derivation matches the reference: UE ``u`` in slot ``s`` uses
``fold_in(fold_in(key, u), s)``.

Under a ``FaultSpec`` the expert output is corrupted and screened each slot
(``_corrupt_and_screen``) and the closed loop runs the degradation ladder;
the streaming executor (``repro_torch.core.streaming``) runs segments of
either loop with an ``active`` mask and a global first slot.  Under a
multi-cell topology (``repro_torch.core.topology``) each slot folds the
per-cell offsets and the inter-cell coupling into its channel, and each
shard runs its block of UEs.  There is one slot loop, so ``use_scan`` has
no effect.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Any, Callable, Mapping, NamedTuple

import numpy as np
import torch

from repro_torch import random as jr
from repro_torch import tracing
from repro_torch.core.closed_loop import (
    DevicePolicy,
    SwitchConfig,
    init_device_switch,
)
from repro_torch.core.expert_bank import ExecutionMode, Expert, ExpertBank
from repro_torch.core.methodology import perturb_estimate
from repro_torch.core.telemetry import trajectory_kpm_matrix
from repro_torch.device import resolve_device
from repro_torch.kernels.tree_infer import policy_step
from repro_torch.phy import dmrs as dmrs_mod
from repro_torch.phy import qam
from repro_torch.phy.ai_estimator import (
    AiEstimator,
    AiEstimatorConfig,
    ai_estimate_from_ls,
)
from repro_torch.phy.channel import (
    ChannelConfig,
    ChannelParams,
    TdlProfile,
    apply_cell_coupling,
    apply_channel,
    channel_params_schedule,
    channel_params_ue_schedule,
    per_ue_params,
    simulate_slot_channel,
    simulate_slot_channel_traced,
)
from repro_torch.phy.equalizer import mmse_equalize
from repro_torch.phy.estimators import WienerInterpolator, estimator_flops, ls_estimate
from repro_torch.phy.link import tb_success, tb_success_dynamic, throughput_bits
from repro_torch.phy.mcs import (
    QM_BY_MCS,
    QM_INDEX_BY_MCS,
    QM_VALUES,
    RATE_BY_MCS,
    n_code_blocks,
    n_code_blocks_table,
    select_mcs,
    select_mcs_index,
    tbs_table,
    transport_block_size,
)
from repro_torch.phy.nr import SlotConfig
from repro_torch.ue_reduce import ue_mean

# MAC overheads (bytes) for the PHY->MAC KPM coupling
_MAC_HEADER_BYTES = 3
_RLC_HEADER_BYTES = 2
_LCID4_FRACTION = 0.95

# OLLA steps: steady-state BLER target = up / (up + down) ~= 10 %
_OLLA_UP_DB = 0.15
_OLLA_DOWN_DB = 1.35
_OLLA_CLAMP_DB = 10.0


@dataclasses.dataclass
class LinkState:
    """The host loop's link-adaptation and cumulative-counter state.

    ``olla_offset_db`` is outer-loop link adaptation: the HARQ ACK/NACK
    driven SINR offset that absorbs the bias of the decision-directed SINR
    measurement, so estimator quality surfaces in the granted MCS.
    """

    reported_snr_db: float = 20.0
    ndi: int = 1
    cum_phy_bits: float = 0.0
    cum_mac_bytes: float = 0.0
    cum_lcid4_bytes: float = 0.0
    slots: int = 0
    olla_offset_db: float = 0.0


class PuschPipeline:
    """One UE's UL PUSCH receive chain with a switchable estimator bank.

    ``ai_params`` is the AI expert's raw weight dict in the port's format
    (``repro_torch.convert.ai_params_from_reference`` carries the
    reference's across).  The bank holds the AI expert first (mode 0, the
    designated buffer) and MMSE as the fail-safe (mode 1); on the card the
    CONCURRENT bank switches with the scalar kernel every slot, mode 0
    included.
    """

    def __init__(
        self,
        cfg: SlotConfig,
        ai_params: Any,
        *,
        net: AiEstimatorConfig = AiEstimatorConfig(),
        execution_mode: ExecutionMode = ExecutionMode.CONCURRENT,
        use_pallas_switch: bool = True,
        rms_delay_spread_s: float = 100e-9,
        device: torch.device | str = "cuda",
    ):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.ai_params = _params_to(ai_params, self.device)
        self.interpolator = WienerInterpolator.build(
            cfg, rms_delay_spread_s=rms_delay_spread_s, device=self.device)
        self._pilots = dmrs_mod.dmrs_sequence(cfg, device=self.device)
        self.bank = ExpertBank(
            [
                Expert(name="ai", fn=ai_estimate_from_ls, params=self.ai_params,
                       flops=net.flops(cfg)),
                Expert(name="mmse", fn=lambda _p, h_ls: self._mmse_from_ls(h_ls),
                       flops=estimator_flops(cfg)),
            ],
            default_mode=1,
            execution_mode=execution_mode,
            use_pallas_switch=use_pallas_switch,
        )

    def _mmse_from_ls(self, h_ls: torch.Tensor) -> torch.Tensor:
        """(ant, dmrs_sym, pilot_sc) -> (ant, 1, n_sc, dmrs_sym), contiguous."""
        from repro_torch.kernels.mmse_interp import mmse_interp

        h_full = mmse_interp(h_ls, self.interpolator.w)
        return h_full.movedim(-2, -1)[:, None].contiguous()

    def _tx_slot(self, key: torch.Tensor, qm: int, tbs_bits: int):
        """bits -> QAM symbols -> resource grid (+ pilots)."""
        cfg = self.cfg
        bits = jr.bernoulli(key, 0.5, (cfg.n_data_re() * qm,)).to(torch.uint8)
        grid = dmrs_mod.map_slot_grid(cfg, qam.modulate(bits, qm)[None], self._pilots)[0]
        return bits, grid, self._pilots

    def _rx_slot(self, mode, rx_grid: torch.Tensor, pilots: torch.Tensor,
                 tx_data_syms: torch.Tensor, noise_var: torch.Tensor, qm: int, *,
                 perturb: bool = False, rho: float = 0.0,
                 perturb_key: torch.Tensor | None = None) -> dict[str, Any]:
        """LS -> expert bank -> switch -> equalize -> demap.

        The measured SINR is decision-directed EVM on the data REs (what the
        receiver reports; it drives link adaptation and the LLR scale); the
        genie per-RE SINR against the known TX symbols drives only the MIESM
        TB model.
        """
        cfg = self.cfg
        h_ls = ls_estimate(cfg, rx_grid, pilots)
        if perturb:
            # methodology stage 1 (paper Fig. 3): MMSE only, AWGN injected at
            # node 2c -- no switching, no AI in the loop
            h_sel = perturb_estimate(self._mmse_from_ls(h_ls), rho, perturb_key)
            all_outputs = None
        else:
            out = self.bank(mode, h_ls)
            h_sel, all_outputs = out.selected, out.all_outputs
        x_hat, _ = mmse_equalize(cfg, rx_grid[None], h_sel[None], noise_var.reshape(1))
        data_hat = dmrs_mod.extract_data_re(cfg, x_hat[0])

        # measured SINR: decision-directed EVM against the nearest point
        points = qam.constellation(qm, data_hat.device)
        nearest = points[torch.argmin(torch.abs(data_hat[:, None] - points[None, :]), dim=1)]
        dd_err = (torch.abs(data_hat - nearest) ** 2).mean()
        sig_pow = (torch.abs(nearest) ** 2).mean()
        sinr_meas = sig_pow / torch.clamp(dd_err, min=1e-9)

        # genie per-RE SINR, smoothed over PRB-sized windows (LDPC averages bursts)
        genie_err = torch.abs(data_hat - tx_data_syms) ** 2
        n = genie_err.shape[0] - genie_err.shape[0] % 12
        genie_sinr = 1.0 / torch.clamp(genie_err[:n].reshape(-1, 12).mean(dim=1), min=1e-9)
        return {
            "h_selected": h_sel,
            "all_outputs": all_outputs,
            "llr": qam.demap_llr(data_hat, 1.0 / sinr_meas, qm),
            "genie_sinr": genie_sinr,
            "rsrp": (torch.abs(h_sel) ** 2).mean(),
            "post_snr_lin": sinr_meas,
        }

    def run_slot(self, key: torch.Tensor, mode, link: LinkState, channel_cfg: ChannelConfig,
                 *, perturb_rho: float | None = None
                 ) -> tuple[LinkState, dict[str, Any], dict[str, Mapping[str, float]]]:
        """Execute one slot; returns (new link state, outputs, KPMs by source)."""
        cfg = self.cfg
        k_tx, k_ch, k_n, k_crc, k_p = jr.split(key, 5)

        # link adaptation from last slot's report + OLLA offset (L2 behaviour)
        mcs = select_mcs(link.reported_snr_db + link.olla_offset_db)
        tbs = transport_block_size(cfg.n_data_re(), mcs)
        bits, tx_grid, pilots = self._tx_slot(k_tx, mcs.qm, tbs)

        fields = simulate_slot_channel(k_ch, cfg, channel_cfg)
        rx_grid = apply_channel(k_n[None], tx_grid[None], {
            "h": fields["h"][None], "interference": fields["interference"][None],
            "noise_var": fields["noise_var"].reshape(1)})[0]

        tx_syms = dmrs_mod.extract_data_re(cfg, tx_grid[0])
        rx = self._rx_slot(mode, rx_grid, pilots, tx_syms, fields["noise_var"], mcs.qm,
                           perturb=perturb_rho is not None,
                           rho=0.0 if perturb_rho is None else perturb_rho,
                           perturb_key=k_p)
        ok = tb_success(rx["genie_sinr"], mcs, key=k_crc)
        # the slot's one read back to the host: link adaptation and the KPMs
        post_snr_lin, rsrp, ok_f = torch.stack(
            [rx["post_snr_lin"], rx["rsrp"], ok.to(torch.float32)]).tolist()
        phy_bits = float(throughput_bits(tbs, torch.tensor(ok_f > 0), cfg.slot_duration_s))

        # -- host-side KPM assembly (Aerial Data Lake + OAI, paper 4.3/6) --
        tb_bytes = tbs / 8.0
        mac_sdu_bytes = max(tb_bytes - _MAC_HEADER_BYTES, 0.0) * ok_f
        lcid4_bytes = max(mac_sdu_bytes - _RLC_HEADER_BYTES, 0.0) * _LCID4_FRACTION
        olla = link.olla_offset_db + (_OLLA_UP_DB if ok_f else -_OLLA_DOWN_DB)
        olla = float(np.clip(olla, -_OLLA_CLAMP_DB, _OLLA_CLAMP_DB))
        snr_db = float(10.0 * np.log10(post_snr_lin + 1e-9))
        new_link = LinkState(
            reported_snr_db=snr_db,
            ndi=1 if ok_f else 0,  # NDI toggles on new data; retx keeps it
            cum_phy_bits=link.cum_phy_bits + phy_bits * cfg.slot_duration_s,
            cum_mac_bytes=link.cum_mac_bytes + mac_sdu_bytes,
            cum_lcid4_bytes=link.cum_lcid4_bytes + lcid4_bytes,
            slots=link.slots + 1,
            olla_offset_db=olla,
        )
        elapsed = new_link.slots * cfg.slot_duration_s
        kpms = {
            "aerial": {
                "code_rate": mcs.code_rate,
                "sinr": snr_db,
                "qam_order": float(mcs.qm),
                "mcs_index": float(mcs.index),
                "tb_size": float(tbs) * ok_f,
                "n_code_blocks": float(n_code_blocks(tbs)) * ok_f,
                "pdu_length": tb_bytes * ok_f,
                "ndi": float(new_link.ndi),
                "rsrp": rsrp,
                "phy_throughput": new_link.cum_phy_bits / elapsed,  # cumulative
            },
            "oai": {
                "snr": snr_db,
                "mac_throughput": new_link.cum_mac_bytes * 8.0 / elapsed,
                "lcid4_throughput": new_link.cum_lcid4_bytes * 8.0 / elapsed,
                "mac_rx_bytes": mac_sdu_bytes,
                "lcid4_rx_bytes": lcid4_bytes,
            },
        }
        outputs = {
            "tb_ok": ok_f,
            "tbs": tbs,
            "mcs": mcs.index,
            "phy_bits_per_s": phy_bits,
            "bits": bits,
            "llr": rx["llr"],
            "rx": rx,
        }
        return new_link, outputs, kpms

    def make_slot_fn(self, channel_schedule: Callable[[int], ChannelConfig]):
        """Adapter for ``ArchesRuntime``: carry = ``LinkState``, input = slot
        index.  Slot ``s`` runs on key ``PRNGKey(s * 2654435761 % 2**31)``,
        as in the reference (independent of the campaign seed)."""

        def slot_fn(active_mode, carry, slot_idx):
            link = carry if carry is not None else LinkState()
            key = jr.PRNGKey(int(slot_idx) * 2654435761 % 2**31, self.device)
            return self.run_slot(key, active_mode, link, channel_schedule(int(slot_idx)))

        return slot_fn


class DeviceLinkState(NamedTuple):
    """Per-UE link state on the device; every leaf is ``(U,)``."""

    reported_snr_db: torch.Tensor  # float32
    olla_offset_db: torch.Tensor  # float32
    ndi: torch.Tensor  # int32
    cum_phy_bits: torch.Tensor  # float32
    cum_mac_bytes: torch.Tensor  # float32
    cum_lcid4_bytes: torch.Tensor  # float32
    slots: torch.Tensor  # int32


def init_device_link(n_ues: int, device: torch.device | str = "cpu") -> DeviceLinkState:
    """Cold-start state matching the host ``LinkState()`` defaults."""

    def f(v):
        return torch.full((n_ues,), v, dtype=torch.float32, device=device)

    return DeviceLinkState(
        reported_snr_db=f(20.0), olla_offset_db=f(0.0),
        ndi=torch.ones(n_ues, dtype=torch.int32, device=device),
        cum_phy_bits=f(0.0), cum_mac_bytes=f(0.0), cum_lcid4_bytes=f(0.0),
        slots=torch.zeros(n_ues, dtype=torch.int32, device=device),
    )


def normalize_modes(modes, n_slots: int, n_ues: int,
                    device: torch.device | str = "cpu") -> torch.Tensor:
    """Broadcast {scalar, (S,), (U,), (S, U)} to an ``(S, U)`` int32 grid.

    A 1-D vector is per-slot when its length is ``n_slots`` and per-UE
    when it is ``n_ues``; with ``n_slots == n_ues`` that is ambiguous and
    rejected.
    """
    if isinstance(modes, torch.Tensor):  # a grid already on a device (any device)
        m = modes.to(device=device, dtype=torch.int32)
    else:
        m = torch.as_tensor(np.asarray(modes), dtype=torch.int32, device=device)
    if m.ndim == 0:
        return torch.full((n_slots, n_ues), int(m), dtype=torch.int32, device=device)
    if m.ndim == 1:
        if n_slots == n_ues and m.shape[0] == n_slots:
            raise ValueError(
                f"1-D modes of length {m.shape[0]} are ambiguous when "
                f"n_slots == n_ues == {n_slots}: pass modes[:, None] "
                "(per-slot) or modes[None, :] (per-UE) explicitly")
        if m.shape[0] == n_slots:
            return m[:, None].expand(n_slots, n_ues).contiguous()
        if m.shape[0] == n_ues:
            return m[None, :].expand(n_slots, n_ues).contiguous()
    elif m.ndim == 2:
        try:
            return torch.broadcast_to(m, (n_slots, n_ues)).contiguous()
        except RuntimeError:
            pass
    raise ValueError(f"modes shape {tuple(m.shape)} vs (n_slots={n_slots}, n_ues={n_ues})")


def resolve_schedule(cfg: SlotConfig, schedule, n_slots: int, n_ues: int,
                     device: torch.device | str = "cpu") -> tuple[TdlProfile, ChannelParams]:
    """Lower a scenario (one schedule, or one per UE) to per-slot params."""
    if callable(schedule):
        return channel_params_schedule(cfg, schedule, n_slots, device)
    schedules = list(schedule)
    if len(schedules) != n_ues:
        raise ValueError(
            f"per-UE schedule list has {len(schedules)} entries for n_ues={n_ues}")
    return channel_params_ue_schedule(cfg, schedules, n_slots, device)


def _stack_tree(items: list) -> Any:
    """Stack per-slot outputs into a trajectory.  Dict keys come out sorted,
    as a ``lax.scan`` trajectory's do in the reference, so KPM names list in
    the same order in both packages."""
    first = items[0]
    if isinstance(first, dict):
        return {k: _stack_tree([it[k] for it in items]) for k in sorted(first)}
    return torch.stack(items, dim=0)


def _map_tree(fn, tree):
    """Apply ``fn`` to every tensor of a nested dict."""
    if isinstance(tree, dict):
        return {k: _map_tree(fn, v) for k, v in tree.items()}
    return fn(tree)


def _rows(mask: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """A ``(U,)`` mask shaped to broadcast over ``x``'s trailing axes."""
    return mask.reshape(mask.shape + (1,) * (x.ndim - 1))


class BatchedPuschPipeline:
    """Multi-UE PUSCH slot engine: batched stages + a slot loop on the device.

    ``ai_params`` is the AI expert's weight dict in the port's format (see
    ``repro_torch.convert`` to carry the reference's across).  The bank
    holds the AI expert first (mode 0, the designated buffer) and MMSE as
    the fail-safe (mode 1).  ``use_pallas_switch`` keeps the reference's
    name and means "use the hand-written switch kernels".

    With ``execution_mode=GATED`` the AI expert runs only on the UEs whose
    committed mode selects it, compacted into a capacity-``gated_capacity``
    sub-batch (``None``: the whole batch); UEs past capacity fall back to
    MMSE for the slot and surface in the trajectory's ``gated_overflow``
    leaf.  ``fused_gated`` runs gather, expert and scatter as one kernel;
    ``audit_nmse_threshold`` reverts UEs whose AI estimate strays from the
    MMSE one (``audit_tripped`` leaf).  Every trajectory carries a per-UE
    ``executed_flops`` leaf.
    """

    def __init__(
        self,
        cfg: SlotConfig,
        ai_params: Any,
        *,
        net: AiEstimatorConfig = AiEstimatorConfig(),
        execution_mode: ExecutionMode = ExecutionMode.CONCURRENT,
        use_pallas_switch: bool = True,
        gated_capacity: int | None = None,
        fused_gated: bool = False,
        expert_dtype: str = "float32",
        audit_nmse_threshold: float | None = None,
        rms_delay_spread_s: float = 100e-9,
        device: torch.device | str = "cuda",
    ):
        execution_mode = ExecutionMode.coerce(execution_mode)
        if fused_gated and execution_mode is not ExecutionMode.GATED:
            raise ValueError("fused_gated requires GATED execution")
        if expert_dtype not in ("float32", "bfloat16"):
            raise ValueError(f"expert_dtype {expert_dtype!r}; one of 'float32', 'bfloat16'")
        self.device = resolve_device(device)
        dev = self.device
        self.cfg = cfg
        self.ai_params = ai_params
        self.interpolator = WienerInterpolator.build(
            cfg, rms_delay_spread_s=rms_delay_spread_s, device=dev)
        self._pilots = dmrs_mod.dmrs_sequence(cfg, device=dev)
        n_re = cfg.n_data_re()
        self._tbs_table = torch.as_tensor(tbs_table(n_re), device=dev)
        self._ncb_table = torch.as_tensor(n_code_blocks_table(n_re), device=dev)
        self._qm_by_mcs = torch.as_tensor(QM_BY_MCS, device=dev)
        self._qm_idx_by_mcs = torch.as_tensor(QM_INDEX_BY_MCS.astype(np.int64), device=dev)
        self._rate_by_mcs = torch.as_tensor(RATE_BY_MCS, device=dev)

        compute_dtype = torch.bfloat16 if expert_dtype == "bfloat16" else None
        params = _params_to(ai_params, dev)
        self.ai = AiEstimator(params, cfg.n_dmrs_sym, compute_dtype).to(dev)
        ai_fn = lambda _p, h_ls: self.ai(h_ls)  # noqa: E731
        #: how a bank that runs the AI expert on every UE runs it on the card
        self.ai_route = None
        if execution_mode is not ExecutionMode.GATED:
            if hasattr(self.ai, "kernel_w"):
                from repro_torch.kernels.gated_expert import ai_expert_dense

                # one fused launch with every UE selected: each UE's estimate
                # is the same bits at any batch and row (a GEMM's are not)
                self.ai_route = "gated_expert"
                backend = "auto" if use_pallas_switch else "ref"

                def ai_fn(_p, h_ls):
                    return ai_expert_dense(h_ls, self.ai, compute_dtype=compute_dtype,
                                           backend=backend)
            else:
                self.ai_route = "folded GEMM"
                if dev.type == "cuda":
                    warnings.warn(
                        "the AI expert's convolutions are not 3x3, which the fused "
                        "gated_expert kernel takes: the bank runs it as folded GEMMs, "
                        "whose bits per UE depend on the batch", stacklevel=2)

        gated_fused_apply = None
        if fused_gated:
            from repro_torch.kernels.gated_expert import gated_expert_apply

            def gated_fused_apply(idx, src, base, h_ls):
                return gated_expert_apply(
                    idx, src, h_ls, base, self.ai, compute_dtype=compute_dtype,
                    backend="auto" if use_pallas_switch else "ref")

        self.bank = ExpertBank(
            [
                Expert(name="ai", fn=ai_fn, params=ai_params, flops=net.flops(cfg)),
                Expert(name="mmse", fn=lambda _p, h_ls: self._mmse_from_ls_batched(h_ls),
                       params=None, flops=estimator_flops(cfg)),
            ],
            default_mode=1,
            execution_mode=execution_mode,
            use_pallas_switch=use_pallas_switch,
            gated_capacity=gated_capacity,
            gated_fused_apply=gated_fused_apply,
            audit_threshold=audit_nmse_threshold,
        )

    def _mmse_from_ls_batched(self, h_ls: torch.Tensor) -> torch.Tensor:
        """(U, ant, dmrs_sym, pilot_sc) -> (U, ant, 1, n_sc, dmrs_sym)."""
        from repro_torch.kernels.mmse_interp import mmse_interp

        h_full = mmse_interp(h_ls, self.interpolator.w)
        return h_full.movedim(-2, -1)[:, :, None].contiguous()

    # -- per-UE stages, batched over the UE axis --------------------------------

    def _ue_pre(self, profile: TdlProfile, p: ChannelParams, snr_db, olla_db, keys):
        """Link adaptation + TX + channel + LS for every UE."""
        cfg = self.cfg
        with tracing.span("slot.tx"):
            ks = jr.split(keys, 4)
            k_tx, k_ch, k_n, k_crc = ks[:, 0], ks[:, 1], ks[:, 2], ks[:, 3]
            n_ues = keys.shape[0]

            mcs_idx = select_mcs_index(snr_db + olla_db)
            qm_idx = self._qm_idx_by_mcs[mcs_idx]
            qm = self._qm_by_mcs[mcs_idx].to(torch.float32)
            code_rate = self._rate_by_mcs[mcs_idx]
            tbs = self._tbs_table[mcs_idx].to(torch.float32)

            # bits drawn once at the widest order and prefix-sliced per order
            n_re = cfg.n_data_re()
            bits = jr.bernoulli(k_tx, 0.5, (n_re * max(QM_VALUES),)).to(torch.uint8)
            syms_all = torch.stack([qam.modulate(bits[:, : n_re * q], q) for q in QM_VALUES])
            syms = syms_all[qm_idx, torch.arange(n_ues, device=keys.device)]

            tx_grid = dmrs_mod.map_slot_grid(cfg, syms, self._pilots)
        with tracing.span("slot.channel"):
            fields = simulate_slot_channel_traced(k_ch, cfg, profile, p)
            rx_grid = apply_channel(k_n, tx_grid, fields)
        with tracing.span("slot.ls"):
            h_ls = ls_estimate(cfg, rx_grid, self._pilots)
        return {
            "mcs_idx": mcs_idx, "qm_idx": qm_idx, "qm": qm, "code_rate": code_rate,
            "tbs": tbs, "syms": syms, "rx_grid": rx_grid, "h_ls": h_ls,
            "noise_var": fields["noise_var"], "k_crc": k_crc,
        }

    def _ue_post(self, link: DeviceLinkState, pre: dict, h_sel: torch.Tensor):
        """Equalize + KPMs + OLLA for every UE."""
        cfg = self.cfg
        n_ues = h_sel.shape[0]
        x_hat, _ = mmse_equalize(cfg, pre["rx_grid"], h_sel, pre["noise_var"])
        data_hat = dmrs_mod.extract_data_re(cfg, x_hat)  # (U, n_re)

        # decision-directed EVM per modulation order, selected per UE
        dd_errs, sig_pows = [], []
        for q in QM_VALUES:
            nearest = qam.nearest_point(data_hat, q)
            dd_errs.append(ue_mean(torch.abs(data_hat - nearest) ** 2, -1))
            sig_pows.append(ue_mean(torch.abs(nearest) ** 2, -1))
        ues = torch.arange(n_ues, device=h_sel.device)
        dd_err = torch.stack(dd_errs)[pre["qm_idx"], ues]
        sig_pow = torch.stack(sig_pows)[pre["qm_idx"], ues]
        sinr_meas = sig_pow / torch.clamp(dd_err, min=1e-9)

        # genie per-RE SINR for the MIESM TB model, PRB-smoothed
        genie_err = torch.abs(data_hat - pre["syms"]) ** 2
        n = genie_err.shape[1] - genie_err.shape[1] % 12
        smoothed = ue_mean(genie_err[:, :n].reshape(n_ues, -1, 12), -1)
        genie_sinr = 1.0 / torch.clamp(smoothed, min=1e-9)

        ok = tb_success_dynamic(genie_sinr, pre["qm"], pre["code_rate"], key=pre["k_crc"])
        ok_f = ok.to(torch.float32)
        tbs = pre["tbs"]
        slot_dur = cfg.slot_duration_s
        phy_bits = torch.where(ok, tbs / slot_dur, torch.zeros_like(tbs))
        rsrp = ue_mean((torch.abs(h_sel) ** 2).reshape(n_ues, -1), -1)

        tb_bytes = tbs / 8.0
        mac_sdu_bytes = torch.clamp(tb_bytes - _MAC_HEADER_BYTES, min=0.0) * ok_f
        lcid4_bytes = torch.clamp(mac_sdu_bytes - _RLC_HEADER_BYTES, min=0.0) * _LCID4_FRACTION

        step = torch.where(ok, torch.full_like(tbs, _OLLA_UP_DB),
                           torch.full_like(tbs, -_OLLA_DOWN_DB))
        olla = torch.clamp(link.olla_offset_db + step, -_OLLA_CLAMP_DB, _OLLA_CLAMP_DB)
        snr_db = 10.0 * torch.log10(sinr_meas + 1e-9)

        new_link = DeviceLinkState(
            reported_snr_db=snr_db,
            olla_offset_db=olla,
            ndi=ok.to(torch.int32),
            cum_phy_bits=link.cum_phy_bits + phy_bits * slot_dur,
            cum_mac_bytes=link.cum_mac_bytes + mac_sdu_bytes,
            cum_lcid4_bytes=link.cum_lcid4_bytes + lcid4_bytes,
            slots=link.slots + 1,
        )
        elapsed = new_link.slots.to(torch.float32) * slot_dur
        kpms = {
            "aerial": {
                "code_rate": pre["code_rate"],
                "sinr": snr_db,
                "qam_order": pre["qm"],
                "mcs_index": pre["mcs_idx"].to(torch.float32),
                "tb_size": tbs * ok_f,
                "n_code_blocks": self._ncb_table[pre["mcs_idx"]].to(torch.float32) * ok_f,
                "pdu_length": tb_bytes * ok_f,
                "ndi": ok_f,
                "rsrp": rsrp,
                "phy_throughput": new_link.cum_phy_bits / elapsed,
            },
            "oai": {
                "snr": snr_db,
                "mac_throughput": new_link.cum_mac_bytes * 8.0 / elapsed,
                "lcid4_throughput": new_link.cum_lcid4_bytes * 8.0 / elapsed,
                "mac_rx_bytes": mac_sdu_bytes,
                "lcid4_rx_bytes": lcid4_bytes,
            },
        }
        outputs = {
            "tb_ok": ok_f,
            "tbs": tbs,
            "mcs": pre["mcs_idx"].to(torch.int32),
            "phy_bits_per_s": phy_bits,
            "kpms": kpms,
        }
        return new_link, outputs

    def _corrupt_and_screen(self, out, h_sel: torch.Tensor, modes: torch.Tensor,
                            corrupt: torch.Tensor, faults) -> tuple[torch.Tensor, torch.Tensor]:
        """Fault injection and the slot's health screen on the selected estimate.

        ``corrupt (U,)`` flags this slot's corruption burst; it lands only on
        UEs served by the AI expert (mode 0; overflowed and audit-reverted UEs
        already hold the fail-safe estimate), as NaN, Inf or a scaled copy per
        ``faults.corruption_kind``.  The screen then checks every AI-served
        UE's estimate for finiteness, whatever the injection (a diverged
        expert trips it too), reverts tripped UEs to the bank's unswitched
        fail-safe estimate (``BankOutput.baseline``) and returns the per-UE
        trip flags.  A scaled corruption stays finite and passes.  With no
        corruption and finite estimates every select is the identity.
        """
        srv = out.served_by if out.served_by is not None else modes.to(torch.int32)
        hit = corrupt & (srv == 0)
        if faults.corruption_kind == "nan":
            bad = torch.full_like(h_sel, float("nan"))
        elif faults.corruption_kind == "inf":
            bad = torch.full_like(h_sel, float("inf"))
        else:
            bad = h_sel * faults.corruption_scale
        h_sel = torch.where(_rows(hit, h_sel), bad, h_sel)
        finite = torch.isfinite(h_sel).reshape(h_sel.shape[0], -1).all(dim=1)
        tripped = (srv == 0) & ~finite
        if out.baseline is None:
            raise ValueError("fault injection needs a batched bank output carrying the "
                             "fail-safe baseline (BankOutput.baseline)")
        h_sel = torch.where(_rows(tripped, h_sel), out.baseline, h_sel)
        return h_sel, tripped.to(torch.int32)

    # -- one batched slot ------------------------------------------------------

    def _slot_core(self, profile: TdlProfile, link: DeviceLinkState,
                   modes: torch.Tensor, keys: torch.Tensor, p: ChannelParams,
                   rho: torch.Tensor | None = None, *, active: torch.Tensor | None = None,
                   faults=None, corrupt: torch.Tensor | None = None, cells=None):
        """One slot for every UE.  With ``rho (U,)`` it is the methodology's
        stage 1 (paper Fig. 3): MMSE only, AWGN injected at node 2c at each
        UE's intensity, no switching and no AI in the loop.

        ``active (U,)`` is the streaming bank-slot mask: a detached lane runs
        the fail-safe expert (so it claims no GATED capacity), its link state
        freezes and every output and KPM leaf is zero; an all-true mask
        leaves the slot bitwise as without it.  ``faults`` with ``corrupt
        (U,)`` injects expert-output corruption and runs the health screen
        (``health_tripped``).  ``cells`` (``repro_torch.core.topology.
        SlotCells``) folds the per-cell offsets and the inter-cell coupling
        into the slot's channel; a detached lane's interference is off first,
        so it adds nothing to its cell's load.
        """
        n_ues = keys.shape[0]
        if active is not None:
            modes = torch.where(active, modes.to(torch.int32),
                                torch.full_like(modes, self.bank.default_mode,
                                                dtype=torch.int32))
        p = per_ue_params(p, n_ues)
        if cells is not None:
            if active is not None:
                p = p._replace(interf_on=torch.where(active, p.interf_on,
                                                     torch.zeros_like(p.interf_on)))
            p = apply_cell_coupling(p, cells.cell_of_ue, cells.params, reduce=cells.reduce)
        pre = self._ue_pre(profile, p, link.reported_snr_db, link.olla_offset_db, keys)
        zeros = torch.zeros(n_ues, dtype=torch.int32, device=keys.device)
        overflow = audit_tripped = health_tripped = zeros
        with tracing.span("slot.bank"):
            if rho is None:
                out = self.bank(modes.to(torch.int32), pre["h_ls"])
                h_sel = out.selected
                exec_flops = self.bank.executed_flops_per_ue(out)
                if out.overflow is not None:
                    overflow = out.overflow.to(torch.int32)
                if out.audit_tripped is not None:
                    audit_tripped = out.audit_tripped.to(torch.int32)
                if faults is not None:
                    h_sel, health_tripped = self._corrupt_and_screen(out, h_sel, modes,
                                                                     corrupt, faults)
            else:
                with tracing.span("bank.mmse"):
                    h_mmse = self._mmse_from_ls_batched(pre["h_ls"])
                h_sel = perturb_estimate(h_mmse, rho, jr.fold_in(keys, 0x9E7))
                exec_flops = torch.full(
                    (n_ues,), self.bank.experts[self.bank.default_mode].flops,
                    dtype=torch.float32, device=keys.device)
        with tracing.span("slot.receiver"):
            new_link, outputs = self._ue_post(link, pre, h_sel)
        outputs["executed_flops"] = exec_flops
        outputs["gated_overflow"] = overflow
        outputs["audit_tripped"] = audit_tripped
        outputs["health_tripped"] = health_tripped
        if active is not None:
            new_link = DeviceLinkState(*(torch.where(active, n, o)
                                         for n, o in zip(new_link, link)))
            outputs = _map_tree(
                lambda x: torch.where(_rows(active, x), x, torch.zeros_like(x)), outputs)
        return new_link, outputs

    def slot_step(self, profile: TdlProfile, link: DeviceLinkState, modes: torch.Tensor,
                  keys: torch.Tensor, p: ChannelParams):
        """One multi-UE slot: ``modes`` and ``keys`` carry the UE axis, ``p``
        is the slot's channel parameters.  Returns ``(link, outputs)``."""
        return self._slot_core(profile, link, modes, keys, p)

    def _ue_keys(self, key, ue_keys, n_ues: int) -> torch.Tensor:
        if ue_keys is not None:
            ue_keys = jr.as_key(ue_keys, self.device)
            if ue_keys.shape[0] != n_ues:
                raise ValueError(f"ue_keys {tuple(ue_keys.shape)} vs n_ues {n_ues}")
            return ue_keys
        key = jr.PRNGKey(0, self.device) if key is None else jr.as_key(key, self.device)
        return jr.fold_in(key, torch.arange(n_ues, device=self.device))

    # -- campaign drivers ------------------------------------------------------

    def _run_open(self, profile, link, ue_keys, modes, params, *, slot0: int = 0,
                  active=None, faults=None, corrupt=None, cells=None):
        """The open loop over ``modes (S, U)``: slot ``s`` folds the global
        slot index ``slot0 + s`` into every UE's key.  ``active``, ``faults``,
        ``corrupt (S, U)`` and ``cells`` as in ``_slot_core``."""
        plain = active is None and faults is None and cells is None
        outs = []
        for s in range(modes.shape[0]):
            keys = jr.fold_in(ue_keys, slot0 + s)
            if plain:  # the public one-slot step, as the reference's use_scan=False loop
                link, out = self.slot_step(profile, link, modes[s], keys, params.at(s))
            else:
                link, out = self._slot_core(
                    profile, link, modes[s], keys, params.at(s), active=active,
                    faults=faults, corrupt=None if corrupt is None else corrupt[s],
                    cells=cells)
            outs.append(out)
        return link, _stack_tree(outs)

    def run(self, schedule: Callable[[int], ChannelConfig], modes, *, n_slots: int,
            n_ues: int, key=None, ue_keys=None, use_scan: bool = True, faults=None):
        """Open-loop ``n_slots x n_ues`` campaign over a declared mode grid.

        ``key`` is the root key (``repro_torch.random.PRNGKey``, or a
        reference ``uint32`` key); returns ``(final_link, trajectory)`` with
        every trajectory leaf ``(n_slots, n_ues)``.  ``faults`` (a
        ``FaultSpec``) injects expert-output corruption behind the health
        screen (decision and telemetry faults exist only in the closed loop).
        """
        dev = self.device
        corrupt = None
        if faults is not None:
            if not use_scan:
                raise ValueError("fault injection needs use_scan=True")
            corrupt = torch.as_tensor(faults.resolve(n_slots, n_ues).corrupt, device=dev)
        profile, params = resolve_schedule(self.cfg, schedule, n_slots, n_ues, dev)
        modes = normalize_modes(modes, n_slots, n_ues, dev)
        ue_keys = self._ue_keys(key, ue_keys, n_ues)
        return self._run_open(profile, init_device_link(n_ues, dev), ue_keys, modes, params,
                              faults=faults, corrupt=corrupt)

    def run_perturbed(self, schedule: Callable[[int], ChannelConfig], rho, *,
                      n_slots: int, key=None, ue_keys=None):
        """Methodology stage-1 campaign: the rho grid rides the UE axis.

        UE ``u`` runs the MMSE-only pipeline with AWGN injected at intensity
        ``rho[u]`` every slot.  Keys derive as in ``run``, with the injected
        noise on its own stream (``fold_in(slot key, 0x9e7)``).  Returns
        ``(final_link, trajectory)``.
        """
        dev = self.device
        rho = torch.as_tensor(np.asarray(rho, np.float32)).to(dev)
        n_ues = rho.shape[0]
        profile, params = resolve_schedule(self.cfg, schedule, n_slots, n_ues, dev)
        ue_keys = self._ue_keys(key, ue_keys, n_ues)
        return self._run_perturbed(profile, ue_keys, rho, params, n_slots)

    def _run_perturbed(self, profile, ue_keys, rho, params, n_slots: int, *, cells=None):
        """The stage-1 loop over ``n_slots`` slots from a cold link."""
        n_ues = ue_keys.shape[0]
        modes = torch.ones(n_ues, dtype=torch.int32, device=self.device)  # MMSE-only stage
        link = init_device_link(n_ues, self.device)
        outs = []
        for s in range(n_slots):
            keys = jr.fold_in(ue_keys, s)
            link, out = self._slot_core(profile, link, modes, keys, params.at(s), rho=rho,
                                        cells=cells)
            outs.append(out)
        return link, _stack_tree(outs)

    def _closed_step(self, profile, sw_cfg, policy, ue_keys, link, sw, slot_idx, p, *,
                     active=None, faults=None, fault_s=None, cells=None):
        """One closed-loop slot: committed modes in, decision out.

        ``faults`` with ``fault_s`` (this slot's ``(decision_valid, corrupt,
        telemetry_valid)`` ``(U,)`` masks) runs the degradation ladder in the
        reference's order: quarantined UEs run the fail-safe expert (claiming
        no GATED capacity) while their register keeps deciding; the estimate
        is corrupted and screened; the decision phase drops masked telemetry
        and lost decisions, the boundary runs the TTL decay, and the slot's
        health and audit trips feed the breaker last.  ``quarantined``
        records the overlay as of the start of the slot.  ``active`` (the
        streaming mask) freezes a detached lane's whole control state and
        zeroes its entries.  For a ``DeviceTreePolicy`` on the card the
        whole decision phase is one ``policy_step`` launch.
        """
        keys = jr.fold_in(ue_keys, slot_idx)
        committed = sw.active_mode
        dv = cor = tv = trip = None
        if faults is not None:
            quarantined = (sw.quarantine > 0).to(torch.int32)
            exec_modes = torch.where(quarantined > 0,
                                     torch.full_like(committed, sw_cfg.default_mode),
                                     committed)
            dv, cor, tv = fault_s
        else:
            quarantined = torch.zeros_like(committed)
            exec_modes = committed
        link, out = self._slot_core(profile, link, exec_modes, keys, p, active=active,
                                    faults=faults, corrupt=cor, cells=cells)
        with tracing.span("slot.decision"):
            vecs = trajectory_kpm_matrix(out["kpms"], sw_cfg.feature_names)
            decide = sw_cfg.period_slots == 1 or slot_idx % sw_cfg.period_slots == 0
            if faults is not None:
                trip = (out["health_tripped"] > 0) | (out["audit_tripped"] > 0)
            new_sw, raw, reg = policy_step(
                sw, vecs, policy, sw_cfg, decide=decide, decision_valid=dv,
                telemetry_valid=tv, trip=trip, active=active, slot_idx=slot_idx,
                faults=faults, return_register=True)
        if active is not None:
            zero = torch.zeros_like(committed)
            committed = torch.where(active, committed, zero)
            quarantined = torch.where(active, quarantined, zero)
        out = dict(out, active_mode=committed, raw_decision=raw, pending_mode=reg,
                   quarantined=quarantined)
        return link, new_sw, out

    def _run_closed(self, profile, sw_cfg, link, sw, ue_keys, params, policy, n_slots: int,
                    *, slot0: int = 0, active=None, faults=None, fault_masks=None,
                    cells=None):
        """The closed loop over ``n_slots`` slots from global slot ``slot0``:
        ``(final link, final switch state, trajectory)``.  ``fault_masks`` is
        the ``(decision_valid, corrupt, telemetry_valid)`` triple of ``(S, U)``
        bool tensors."""
        outs = []
        for s in range(n_slots):
            with tracing.span("slot", self.device, slot=slot0 + s):
                fs = None if fault_masks is None else tuple(m[s] for m in fault_masks)
                link, sw, out = self._closed_step(profile, sw_cfg, policy, ue_keys, link, sw,
                                                  slot0 + s, params.at(s), active=active,
                                                  faults=faults, fault_s=fs, cells=cells)
            outs.append(out)
        with tracing.span("campaign.history"):
            return link, sw, _stack_tree(outs)

    def run_closed_loop(self, schedule: Callable[[int], ChannelConfig],
                        policy: DevicePolicy, sw_cfg: SwitchConfig, *, n_slots: int,
                        n_ues: int, key=None, ue_keys=None, use_scan: bool = True,
                        faults=None):
        """Campaign with the switching decision inside the slot loop.

        Each slot runs the mode committed at the previous boundary; its KPMs
        enter the per-UE window, the device policy decides, and the decision
        takes effect at the next boundary.  Returns ``(final_link,
        final_switch_state, trajectory)``; the trajectory adds
        ``active_mode`` / ``raw_decision`` / ``pending_mode`` /
        ``quarantined`` to ``run``'s leaves.  ``faults`` (a ``FaultSpec``)
        runs the whole degradation ladder: decision loss and the TTL decay,
        corruption, the health screen and the breaker, telemetry loss.
        """
        dev = self.device
        # the loop's set-up: the schedule, the UEs' keys, the fault masks' uploads
        # and the link's and the switch's initial state
        with tracing.span("campaign.init"):
            profile, params = resolve_schedule(self.cfg, schedule, n_slots, n_ues, dev)
            ue_keys = self._ue_keys(key, ue_keys, n_ues)
            fault_masks = None
            if faults is not None:
                rf = faults.resolve(n_slots, n_ues)
                fault_masks = tuple(torch.as_tensor(m, device=dev) for m in (
                    rf.decision_valid, rf.corrupt, rf.telemetry_valid))
            link = init_device_link(n_ues, dev)
            sw = init_device_switch(n_ues, len(sw_cfg.feature_names), sw_cfg, dev,
                                    faults=faults)
        return self._run_closed(profile, sw_cfg, link, sw, ue_keys, params, policy, n_slots,
                                faults=faults, fault_masks=fault_masks)


def _params_to(params: Any, device: torch.device) -> Any:
    if isinstance(params, dict):
        return {k: _params_to(v, device) for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return [_params_to(v, device) for v in params]
    if isinstance(params, torch.Tensor):
        return params.to(device=device, dtype=torch.float32)
    return torch.as_tensor(np.asarray(params, np.float32), device=device)
