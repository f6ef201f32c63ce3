"""ARCHES core of the port: the paper's contribution as composable PyTorch modules.

The names mirror ``repro.core``'s, apart from the reference's JAX UE mesh
factory ``make_ue_mesh``: ``CellTopology.build`` over a process group
stands in for it (``repro_torch.core.topology``).  The training meshes
(``make_production_mesh``, ``make_cpu_mesh``) are descriptors whose
``device_mesh()`` builds a ``DeviceMesh`` over a group of that many ranks.
"""

from repro_torch.core.closed_loop import (
    DeviceSwitchState,
    DeviceThresholdPolicy,
    DeviceTreePolicy,
    PerUEPolicy,
    SwitchConfig,
    export_tree_tables,
    host_replay_closed_loop,
    init_device_switch,
    per_ue_policy,
    policy_infer,
    switch_boundary,
    switch_update,
)
from repro_torch.core.dapp import ControlLoopLatency, DApp, Decision, connect_dapp
from repro_torch.core.e3 import (
    E3Agent,
    E3ControlMessage,
    E3IndicationMessage,
    E3Manager,
    E3Subscription,
)
from repro_torch.core.expert_bank import BankOutput, ExecutionMode, Expert, ExpertBank
from repro_torch.core.methodology import (
    ClusterResult,
    SweepResult,
    design_policy_inputs,
    monotonicity_filter,
    perturb_estimate,
    redundancy_reduction,
    sensitivity_sweep,
)
from repro_torch.core.policy import (
    DecisionTreePolicy,
    FittedTree,
    ThresholdPolicy,
    classification_metrics,
    fit_decision_tree,
    profile_and_fit_tree,
)
from repro_torch.core.runtime import (
    ArchesRuntime,
    BatchedRunHistory,
    RunHistory,
    SlotRecord,
    replay_batched_telemetry,
    suggest_gated_capacity,
)
from repro_torch.core.session import (
    ArchesSession,
    CampaignSpec,
    ExecutionPath,
    ExpertBankSpec,
    PolicySpec,
    SwitchSpec,
    spec_hash,
)
from repro_torch.core.switch import (
    SlotSwitchState,
    commit_decision,
    init_switch_state,
    slot_boundary,
)
from repro_torch.core.topology import (
    CellTopology,
    TopologySpec,
    make_cpu_mesh,
    make_production_mesh,
    per_shard_capacity,
    run_closed_loop_sharded,
    run_perturbed_sharded,
    run_sharded,
)
from repro_torch.core.telemetry import (
    AERIAL_CANDIDATE_KPMS,
    AERIAL_CUMULATIVE_KPMS,
    ALL_CANDIDATE_KPMS,
    OAI_CANDIDATE_KPMS,
    SELECTED_KPMS,
    KPMRing,
    kpm_vector,
    ring_init,
    ring_matrix,
    ring_push,
    ring_window_mean,
)
