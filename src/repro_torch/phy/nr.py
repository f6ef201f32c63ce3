"""5G NR UL slot numerology and PUSCH dimensioning (paper 4.1, 5.1).

Defaults match the paper's X5G configuration: 30 kHz subcarrier spacing
(500 us slots), 14 OFDM symbols per slot, DMRS type-1 on symbols {0, 5, 10}
with comb-2 frequency interleaving, N_ant = 4 receive antenna ports,
N_l = 1 transmission layer.
"""

from __future__ import annotations

import dataclasses

import numpy as np

# 3GPP TS 38.211 constants
N_SC_PER_PRB = 12
N_SYM_PER_SLOT = 14


@dataclasses.dataclass(frozen=True)
class SlotConfig:
    """Dimensions of one UL PUSCH slot (paper 4.1)."""

    n_prb: int = 106  # PRBs allocated for UL transmission
    n_ant: int = 4  # receive antenna ports (N_ant)
    n_layers: int = 1  # transmission layers (N_l)
    dmrs_symbols: tuple[int, ...] = (0, 5, 10)  # DMRS type-1, paper Fig. 6
    dmrs_comb_offset: int = 0  # comb-2: pilots on subcarriers 2k + offset
    scs_khz: int = 30  # subcarrier spacing -> 500 us slots

    @property
    def n_sc(self) -> int:
        """Total subcarriers N_sc = 12 * N_PRB."""
        return N_SC_PER_PRB * self.n_prb

    @property
    def n_sym(self) -> int:
        return N_SYM_PER_SLOT

    @property
    def n_dmrs_sym(self) -> int:
        """N_sym^DMRS (= 3 in the paper)."""
        return len(self.dmrs_symbols)

    @property
    def n_pilot_sc(self) -> int:
        """Comb-2 pilots: every other subcarrier."""
        return self.n_sc // 2

    @property
    def slot_duration_s(self) -> float:
        return 1e-3 / (self.scs_khz // 15)

    @property
    def pilot_sc_indices(self) -> np.ndarray:
        """Subcarrier indices carrying DMRS (comb-2 interleave)."""
        return np.arange(self.dmrs_comb_offset, self.n_sc, 2)

    @property
    def data_sc_indices(self) -> np.ndarray:
        """Subcarrier indices carrying PUSCH data on DMRS symbols."""
        return np.arange(1 - self.dmrs_comb_offset, self.n_sc, 2)

    @property
    def data_symbols(self) -> np.ndarray:
        """OFDM symbol indices carrying only data."""
        return np.asarray([s for s in range(N_SYM_PER_SLOT) if s not in self.dmrs_symbols])

    def n_data_re(self) -> int:
        """Resource elements available for PUSCH data in one slot/layer.

        Data symbols carry all subcarriers; DMRS symbols carry data on the
        other comb (interleaved frequency-domain CDM, paper Fig. 6).
        """
        full = (N_SYM_PER_SLOT - self.n_dmrs_sym) * self.n_sc
        on_dmrs = self.n_dmrs_sym * (self.n_sc - self.n_pilot_sc)
        return full + on_dmrs


DEFAULT_SLOT = SlotConfig()
