"""5G NR PUSCH substrate of the port: the paper's case-study domain (paper 5/6)."""

from repro_torch.phy.nr import DEFAULT_SLOT, SlotConfig
from repro_torch.phy.channel import (
    INDOOR_LOS,
    INDOOR_NLOS,
    ChannelConfig,
    TdlProfile,
    apply_channel,
    simulate_slot_channel,
)
from repro_torch.phy.estimators import WienerInterpolator, ls_estimate, mmse_estimate
from repro_torch.phy.ai_estimator import (
    AiEstimatorConfig,
    ai_estimate_from_ls,
    init_params,
    train_ai_estimator,
)
from repro_torch.phy.equalizer import mmse_equalize, time_interpolate
from repro_torch.phy.pipeline import LinkState, PuschPipeline
from repro_torch.phy.scenario import (
    GOOD,
    POOR,
    POOR_WINDOW,
    PoorWindow,
    Scenario,
    bursty_interference_schedule,
    condition_label,
    constant_schedule,
    get_scenario,
    good_poor_good_schedule,
    make_schedule,
    register_scenario,
    scenario_names,
    scenario_params,
    snr_ramp_schedule,
)

__all__ = [
    "DEFAULT_SLOT",
    "SlotConfig",
    "ChannelConfig",
    "TdlProfile",
    "INDOOR_LOS",
    "INDOOR_NLOS",
    "apply_channel",
    "simulate_slot_channel",
    "WienerInterpolator",
    "ls_estimate",
    "mmse_estimate",
    "AiEstimatorConfig",
    "ai_estimate_from_ls",
    "init_params",
    "train_ai_estimator",
    "mmse_equalize",
    "time_interpolate",
    "LinkState",
    "PuschPipeline",
    "GOOD",
    "POOR",
    "POOR_WINDOW",
    "PoorWindow",
    "Scenario",
    "bursty_interference_schedule",
    "condition_label",
    "constant_schedule",
    "get_scenario",
    "good_poor_good_schedule",
    "make_schedule",
    "register_scenario",
    "scenario_names",
    "scenario_params",
    "snr_ramp_schedule",
]
