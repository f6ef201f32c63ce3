"""MCS table, TBS computation and link adaptation (TS 38.214 5.1.3).

Host tables are numpy (a copy of ``repro.phy.mcs``); ``select_mcs`` is the
host loop's link adaptation on a Python float, and ``select_mcs_index`` the
per-UE device lookup the batched engine runs every slot.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.device import cached_const

# TS 38.214 Table 5.1.3.1-2 (MCS index table 2, 256QAM), entries 0..27:
# (modulation order Qm, target code rate x1024).
_MCS_TABLE: tuple[tuple[int, float], ...] = (
    (2, 120), (2, 193), (2, 308), (2, 449), (2, 602), (4, 378), (4, 434),
    (4, 490), (4, 553), (4, 616), (4, 658), (6, 466), (6, 517), (6, 567),
    (6, 616), (6, 666), (6, 719), (6, 772), (6, 822), (6, 873), (8, 682.5),
    (8, 711), (8, 754), (8, 797), (8, 841), (8, 885), (8, 916.5), (8, 948),
)

MAX_MCS = len(_MCS_TABLE) - 1
_CB_MAX_BITS = 8448  # LDPC base-graph-1 max code-block size


@dataclasses.dataclass(frozen=True)
class McsEntry:
    index: int
    qm: int  # modulation order (bits/symbol)
    code_rate: float  # info bits / coded bits

    @property
    def spectral_efficiency(self) -> float:
        return self.qm * self.code_rate


def mcs_entry(index: int) -> McsEntry:
    index = int(np.clip(index, 0, MAX_MCS))
    qm, r1024 = _MCS_TABLE[index]
    return McsEntry(index=index, qm=qm, code_rate=r1024 / 1024.0)


def transport_block_size(n_data_re: int, mcs: McsEntry, n_layers: int = 1) -> int:
    """Simplified TS 38.214 5.1.3.2 TBS (byte-aligned, CRC excluded)."""
    n_info = n_data_re * mcs.qm * mcs.code_rate * n_layers
    return int(max(24, np.floor(n_info / 8.0) * 8 - 24))


def n_code_blocks(tbs_bits: int) -> int:
    """Code-block segmentation count (TS 38.212 5.2.2)."""
    b = tbs_bits + 24
    if b <= _CB_MAX_BITS:
        return 1
    return int(np.ceil(b / (_CB_MAX_BITS - 24)))


def _snr_threshold_db(mcs: McsEntry) -> float:
    se = mcs.spectral_efficiency
    return float(10.0 * np.log10(2.0**se - 1.0) + 1.0)  # Shannon gap ~1 dB


SNR_THRESHOLDS_DB = np.asarray(
    [_snr_threshold_db(mcs_entry(i)) for i in range(MAX_MCS + 1)]
)

def select_mcs(snr_db: float, *, backoff_db: float = 1.0) -> McsEntry:
    """Outer-loop-free link adaptation: highest MCS whose threshold fits."""
    eligible = np.nonzero(SNR_THRESHOLDS_DB <= snr_db - backoff_db)[0]
    idx = int(eligible[-1]) if eligible.size else 0
    return mcs_entry(idx)


QM_BY_MCS = np.asarray([q for q, _ in _MCS_TABLE], np.int32)
RATE_BY_MCS = np.asarray([r / 1024.0 for _, r in _MCS_TABLE], np.float32)
QM_VALUES = (2, 4, 6, 8)
QM_INDEX_BY_MCS = np.asarray(
    [QM_VALUES.index(q) for q, _ in _MCS_TABLE], np.int32
)


def tbs_table(n_data_re: int, n_layers: int = 1) -> np.ndarray:
    """Transport block size for every MCS index, (MAX_MCS+1,) int32."""
    return np.asarray(
        [transport_block_size(n_data_re, mcs_entry(i), n_layers)
         for i in range(MAX_MCS + 1)],
        np.int32,
    )


def n_code_blocks_table(n_data_re: int, n_layers: int = 1) -> np.ndarray:
    """Code-block count for every MCS index, (MAX_MCS+1,) int32."""
    return np.asarray(
        [int(n_code_blocks(int(t))) for t in tbs_table(n_data_re, n_layers)],
        np.int32,
    )


def select_mcs_index(snr_db: torch.Tensor, *, backoff_db: float = 1.0) -> torch.Tensor:
    """Per-UE link adaptation: highest MCS whose SNR threshold fits.

    ``SNR_THRESHOLDS_DB`` increases monotonically, so the index is a count
    of eligible thresholds minus one (int64, clamped at 0).
    """
    th = cached_const(("snr_thresholds",), snr_db.device,
                      lambda: SNR_THRESHOLDS_DB.astype(np.float32))
    snr = snr_db.to(torch.float32)
    n_eligible = (th <= (snr[..., None] - backoff_db)).sum(dim=-1)
    return torch.clamp(n_eligible - 1, min=0)
