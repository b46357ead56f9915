"""Typed configuration for the MIMO-OFDM modem.

This single dataclass covers the union of the reference's three config tiers
(compile-time #defines in mimo/config.h, the boost::program_options CLI in
mimo/main.cc:174-250, and the GUI's JSON device store): OFDM dimensions,
preamble LFSR polynomials, communication mode, modulation scheme, detector,
and mesh shape.  The reference's compile-time variants (USE_ALL_CARRIERS,
SISO, INVERT_TO_UNITY, ...) become runtime fields here.

Reference citations:
  - OFDM dims M=2048, CP=152: mimo/config.h:65-66
  - LFSR polynomials (octal):  mimo/config.h:70-75
  - plateau threshold 0.95:    mimo/config.h:87
  - NUM_ACCESS_CODES=20, NUM_STREAMS=2, PID_MAX=1000: mimo/config.h:92,104,106
  - modem LIQUID_MODEM_ARB32OPT / ARITY 32: mimo/config.h:107-108
  - communication modes: Interface/types.h:21-26
  - modulation choices:  Interface/usrp_device.h:11-14
"""

from __future__ import annotations

import dataclasses
import enum
import json
from typing import Optional, Tuple


class CommMode(enum.Enum):
    """Communication modes, after Interface/types.h:21-26."""

    SISO = "siso"
    RX_DIVERSITY = "rx_diversity"
    RX_ZF = "rx_zf"
    RX_BEAMFORMING = "rx_beamforming"
    TX_BEAMFORMING = "tx_beamforming"
    # new (beyond types.h): Alamouti space-time block coding
    ALAMOUTI = "alamouti"


class Detector(enum.Enum):
    """Per-subcarrier MIMO detector."""

    ZF = "zf"          # zero-forcing (channel inversion), reference default
    MMSE = "mmse"      # linear MMSE (new capability)
    ML = "ml"          # joint maximum-likelihood lattice search (new)
    SIC = "sic"        # MMSE V-BLAST successive cancellation (new)


class Modulation(enum.Enum):
    """Payload modulation schemes.

    ARB32OPT mirrors the reference's LIQUID_MODEM_ARB32OPT 32-ary modem
    (mimo/config.h:107); QAM4/16/64 mirror the GUI's MOD_QUAM choices
    (Interface/usrp_device.h:11-14); BPSK/QPSK mirror the constellation
    tables in mimo/framing.cc:35-46.
    """

    BPSK = "bpsk"
    QPSK = "qpsk"
    QAM16 = "qam16"
    QAM64 = "qam64"
    QAM256 = "qam256"
    ARB32OPT = "arb32opt"

    @property
    def bits_per_symbol(self) -> int:
        return {
            Modulation.BPSK: 1,
            Modulation.QPSK: 2,
            Modulation.QAM16: 4,
            Modulation.ARB32OPT: 5,
            Modulation.QAM64: 6,
            Modulation.QAM256: 8,
        }[self]

    @property
    def arity(self) -> int:
        return 1 << self.bits_per_symbol


# Degree-12 / degree-13 primitive polynomial defaults (octal as in the
# reference, mimo/config.h:70-75).  Extra degree-13 primitive polynomials
# (for >2 streams, e.g. the 4x4 configuration) are found at runtime by
# rub_mimo_tpu.ofdm.lfsr.find_primitive_polys and appended deterministically.
LFSR_SMALL_LENGTH = 12
LFSR_LARGE_LENGTH = 13
LFSR_SMALL_0_GEN_POLY = 0o10123
LFSR_SMALL_1_GEN_POLY = 0o10151
LFSR_LARGE_0_GEN_POLY = 0o20033
LFSR_LARGE_1_GEN_POLY = 0o20047


@dataclasses.dataclass(frozen=True)
class ModemConfig:
    """Full modem configuration (frame + preamble + modem + detector)."""

    # --- OFDM dimensions (mimo/config.h:65-66) ---
    num_subcarriers: int = 2048
    cp_len: int = 152

    # --- MIMO shape (mimo/config.h:104-106) ---
    num_streams: int = 2
    num_access_codes: int = 20

    # --- payload (mimo/config.h:92,107-108) ---
    pid_max: int = 1000
    modulation: Modulation = Modulation.ARB32OPT

    # --- subcarrier allocation (mimo/config.h:95-96) ---
    use_all_carriers: bool = True
    add_null_carriers: bool = True

    # --- reference's compiled-out variants, runtime-selectable here ---
    # MAKE_S1_QPSK (mimo/config.h:101, framing.cc:1160-1212): S1 access
    # codes carry QPSK points instead of BPSK, with the variant's quirks
    # replicated (the `& 0x11` symbol mask that only ever selects table
    # entries 0/1, and the 1/sqrt(M_occupied) normalization this variant
    # uses where the BPSK one divides by sqrt(M)).
    s1_qpsk: bool = False
    # SAME_SIGNAL_ON_ALL_TX (mimo/main.cc:1223-1233): every TX antenna
    # repeats stream 0's payload symbols.
    same_signal_on_all_tx: bool = False

    # --- sync (mimo/config.h:87) ---
    plateau_threshold: float = 0.95
    # Robust-mode quorum plateau rule (new capability): fire when at
    # least sync_quorum streams each hold a metric run longer than
    # cp_len, instead of the reference's ALL-streams rule
    # (framing.cc:601-623).  At 4+ rx streams the all-streams rule is
    # gated by the weakest rx<-tx0 link (S0 is transmitted on tx0 only),
    # so a faded row silently blocks acquisition; a quorum of e.g. 3/4
    # keeps the plateau detector usable without the S0-xcorr fallback.
    # None = all streams (the reference rule; required by bit_exact).
    # sync_index is the floor-mean of the run starts of the streams
    # satisfying the rule at the fire sample.
    sync_quorum: Optional[int] = None

    # --- preamble LFSRs (mimo/config.h:70-75) ---
    lfsr_small_length: int = LFSR_SMALL_LENGTH
    lfsr_large_length: int = LFSR_LARGE_LENGTH
    lfsr_small_poly: int = LFSR_SMALL_0_GEN_POLY
    lfsr_large_polys: Tuple[int, ...] = (
        LFSR_LARGE_0_GEN_POLY,
        LFSR_LARGE_1_GEN_POLY,
    )

    # --- mode / detector ---
    mode: CommMode = CommMode.RX_ZF
    detector: Detector = Detector.ZF
    siso_tx: int = 1            # mimo/config.h:90
    siso_rx: int = 1            # mimo/config.h:91
    invert_to_unity: bool = False   # mimo/config.h:103
    mmse_noise_var: float = 1e-2    # sigma^2 for the MMSE detector
    # estimate sigma^2 from the access-code residuals instead of using
    # mmse_noise_var (estimate.ls.estimate_noise_var) — parameter-free MMSE
    mmse_auto_noise: bool = False

    # --- bit-exact replication quirks ---
    # The reference initializes Ghat to identity and accumulates on top of it
    # without zeroing (mimo/framing.cc:302-319, 811), leaving a
    # dft_normalizer/num_access_codes bias on the diagonal.  bit_exact=True
    # replicates that; False computes the clean LS estimate.
    bit_exact: bool = True

    # --- CFO (new capability; the reference has only a FIXME,
    #     mimo/main.cc "FIXME correct frequency offset", framing.cc:486) ---
    correct_cfo: bool = False

    # --- matched-filter timing mode ---
    # "per_code": independent argmax per (rx, access code) — the reference's
    #   behaviour (framing.cc:702-744), fragile on weak cross-channels (its
    #   own FIXME at framing.cc:797-800 notes the peaks should be
    #   symbol_len apart).
    # "joint": pool correlation energy over all codes/streams/rx at a
    #   common base offset, one global argmax (new, more robust).
    # bit_exact=True forces "per_code".
    timing_mode: str = "joint"

    # --- sync fallback (new capability) ---
    # When the S&C plateau never fires (it cannot below ~16 dB SNR with
    # the reference's 0.95 threshold), fall back to a normalized S0
    # matched filter over the capture (sync.xcorr_sync); acquires at the
    # full M-sample processing gain.  quality must exceed
    # sync_fallback_threshold.
    sync_fallback: bool = False
    sync_fallback_threshold: float = 0.3

    # --- delay-domain channel-estimate denoising (new capability) ---
    # Truncate Ghat's impulse response to the CP span (estimate.smooth):
    # ~10*log10(M/cp) dB extra estimation SNR when the channel is causal
    # within the CP.  All-carriers allocation only.
    smooth_channel: bool = False

    # --- decision-directed common-phase tracking (new capability) ---
    # Per OFDM symbol: demap, estimate the common phase error against the
    # decisions, derotate, demap again.  Cleans up residual CFO-induced
    # phase ramps across long payloads.
    track_phase: bool = False

    # --- decision-directed channel tracking (new capability) ---
    # Track the full per-subcarrier MIMO channel across the payload in
    # blocks (detect.tracking): follows drift the reference's one-shot
    # preamble estimate cannot.  ZF-family modes only.
    track_channel: bool = False
    track_block_frames: int = 16
    track_alpha: float = 0.5

    # --- RX amplitude compensation ---
    # The reference's mixed normalization conventions (S1 scaled by
    # 1/sqrt(M) but payload/RX by 1/sqrt(M_occupied)) leave a systematic
    # sqrt(M/M_occupied) amplitude on equalized symbols whenever guard
    # bands/pilots are enabled (harmless for the all-carriers default
    # where M_occupied == M; breaks QAM hard decisions otherwise).
    # True multiplies equalized symbols by sqrt(M_occupied/M).
    normalize_rx_scale: bool = False

    # --- RF operating point (mimo/config.h:55-59); informational for the
    #     file-replay pipeline, used by the simulator & manifests ---
    center_frequency: float = 2450e6
    sample_rate: float = 1.0e6
    tx_gain: float = 67.0
    rx_gain: float = 45.0
    baseband_gain: float = 0.25

    # ------------------------------------------------------------------ #
    # derived quantities
    # ------------------------------------------------------------------ #
    @property
    def M(self) -> int:
        return self.num_subcarriers

    @property
    def M2(self) -> int:
        return self.num_subcarriers // 2

    @property
    def symbol_len(self) -> int:
        return self.num_subcarriers + self.cp_len

    @property
    def num_sync_symbols(self) -> int:
        """Sync word count: 1 S0 symbol + TDMA access codes.

        mimo/framing.cc:174-175: (num_access_codes*num_streams + 1) symbols.
        """
        return self.num_access_codes * self.num_streams + 1

    @property
    def sync_words_len(self) -> int:
        return self.num_sync_symbols * self.symbol_len

    @property
    def access_code_buffer_len(self) -> int:
        """Capture window for the access-code region, mimo/framing.cc:284."""
        return self.symbol_len * (self.num_access_codes * self.num_streams + 4)

    @property
    def tx_sig_samples(self) -> int:
        """Payload length in samples, mimo/framing.cc:285."""
        return self.pid_max * self.symbol_len

    @property
    def window_len(self) -> int:
        """Total replay window: access codes + payload, framing.cc:387-388."""
        return self.access_code_buffer_len + self.tx_sig_samples

    @property
    def arity(self) -> int:
        return self.modulation.arity

    def subcarrier_allocation(self):
        from rub_mimo_tpu.ofdm import sctype

        return sctype.init_default_sctype(
            self.num_subcarriers,
            use_all_carriers=self.use_all_carriers,
            add_null_carriers=self.add_null_carriers,
        )

    @property
    def M_occupied(self) -> int:
        from rub_mimo_tpu.ofdm import sctype

        p = self.subcarrier_allocation()
        _, m_pilot, m_data = sctype.validate_sctype(p)
        return m_pilot + m_data

    # ------------------------------------------------------------------ #
    # (de)serialization — successor of the GUI's JSON device store
    # (Interface/usrp_device.cpp:11-50, mainwindow.cpp:106-149)
    # ------------------------------------------------------------------ #
    def to_json(self) -> str:
        d = dataclasses.asdict(self)
        d["modulation"] = self.modulation.value
        d["mode"] = self.mode.value
        d["detector"] = self.detector.value
        d["lfsr_large_polys"] = list(self.lfsr_large_polys)
        return json.dumps(d, indent=2)

    @classmethod
    def from_json(cls, s: str) -> "ModemConfig":
        d = json.loads(s)
        d["modulation"] = Modulation(d["modulation"])
        d["mode"] = CommMode(d["mode"])
        d["detector"] = Detector(d["detector"])
        d["lfsr_large_polys"] = tuple(d["lfsr_large_polys"])
        return cls(**d)

    def replace(self, **kw) -> "ModemConfig":
        return dataclasses.replace(self, **kw)

    def validate(self) -> "ModemConfig":
        """Sanity-check parameters (the GUI's form validation,
        Interface/mainwindow.cpp:246-289, plus the DSP invariants the
        reference only asserts at runtime).  Returns self for chaining."""
        if self.num_subcarriers < 8 or (self.num_subcarriers & (self.num_subcarriers - 1)):
            raise ValueError("num_subcarriers must be a power of two >= 8")
        if not (0 < self.cp_len <= self.num_subcarriers):
            raise ValueError("cp_len must be in (0, num_subcarriers]")
        if self.num_streams < 1:
            raise ValueError("num_streams must be >= 1")
        if self.num_access_codes < 1:
            raise ValueError("num_access_codes must be >= 1")
        if self.pid_max < 1:
            raise ValueError("pid_max must be >= 1")
        if not (0 <= self.siso_tx < self.num_streams
                and 0 <= self.siso_rx < self.num_streams):
            raise ValueError("siso_tx/siso_rx out of range")
        if not (0.0 < self.plateau_threshold):
            raise ValueError("plateau_threshold must be positive")
        if self.sync_quorum is not None:
            if not (1 <= self.sync_quorum <= self.num_streams):
                raise ValueError("sync_quorum must be in [1, num_streams]")
            if self.bit_exact and self.sync_quorum != self.num_streams:
                raise ValueError(
                    "bit_exact requires the reference's all-streams "
                    "plateau rule (sync_quorum=None)")
        if self.timing_mode not in ("joint", "per_code"):
            raise ValueError("timing_mode must be 'joint' or 'per_code'")
        if self.track_channel and self.mode not in (
            CommMode.RX_ZF, CommMode.RX_BEAMFORMING
        ):
            raise ValueError("track_channel requires a ZF-family mode")
        if self.track_channel and self.pid_max % self.track_block_frames:
            raise ValueError(
                "track_channel requires pid_max divisible by "
                "track_block_frames"
            )
        if self.detector in (Detector.ML, Detector.SIC):
            if self.mode not in (CommMode.RX_ZF, CommMode.RX_BEAMFORMING):
                raise ValueError(
                    f"{self.detector.value} detection requires a "
                    "full-MIMO mode"
                )
            if self.track_channel:
                raise ValueError(
                    "track_channel refits through the linear equalizer; "
                    "use detector zf/mmse with it"
                )
        if self.detector == Detector.ML:
            if self.arity ** self.num_streams > 4096:
                raise ValueError(
                    "ML search space arity**num_streams exceeds 4096; "
                    "use a smaller constellation, sic, or mmse"
                )
        if self.smooth_channel and not self.use_all_carriers:
            raise ValueError(
                "smooth_channel needs the all-carriers allocation (guard "
                "bands make the delay-domain support leak)"
            )
        if self.mode == CommMode.ALAMOUTI:
            if self.num_streams != 2:
                raise ValueError("ALAMOUTI requires num_streams == 2")
            if self.pid_max % 2:
                raise ValueError("ALAMOUTI requires an even pid_max")
        if self.sample_rate <= 0 or self.center_frequency <= 0:
            raise ValueError("sample_rate/center_frequency must be positive")
        return self


DEFAULT_CONFIG = ModemConfig()


def tiny_config(**kw) -> ModemConfig:
    """A small config for tests and multi-chip dry runs."""
    base = dict(
        num_subcarriers=64,
        cp_len=16,
        num_streams=2,
        num_access_codes=4,
        pid_max=8,
        modulation=Modulation.QPSK,
    )
    base.update(kw)
    return ModemConfig(**base)
