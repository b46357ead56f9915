"""Scoring and experiment reporting.

Replaces the reference's end-of-run scoring loop and printf report
(mimo/main.cc:1394-1470): per-stream valid-symbol counts, symbol error
rate, plateau/sync statistics, runtimes and bit rate — plus structured
JSON metrics the reference never had (SURVEY §5 observability).
"""

from __future__ import annotations

import dataclasses
import json
from typing import Dict, Optional

import numpy as np

from rub_mimo_tpu.config import CommMode, ModemConfig
from rub_mimo_tpu.pipeline.rx import DecodeResult
from rub_mimo_tpu.utils.transfer import fetch_tree


@dataclasses.dataclass
class ExperimentReport:
    synced: bool
    sync_index: int
    plateau_start: list
    plateau_end: list
    plateau_width: list
    num_occupied_carriers: int
    frames_decoded: int
    symbols_transmitted: int
    valid_symbols: list            # per stream
    symbol_error_rate: list        # per stream, in percent (reference prints %)
    bit_error_rate: Optional[list] = None
    evm_percent: Optional[list] = None     # error vector magnitude per stream
    cfo_hat: float = 0.0
    samples_processed: int = 0
    decode_seconds: float = 0.0
    samples_per_second: float = 0.0
    extra: Dict = dataclasses.field(default_factory=dict)

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2)

    def print(self) -> None:
        """Human-readable block in the spirit of main.cc:1430-1469."""
        r = self
        print(f"    synced                  : {r.synced}")
        for i, (ps, pe, pw) in enumerate(
            zip(r.plateau_start, r.plateau_end, r.plateau_width)
        ):
            print(f"    plateau width {i+1}         : {pw:6d}")
            print(f"    plateau start {i+1}         : {ps:6d}")
            print(f"    plateau end   {i+1}         : {pe:6d}")
        print(f"    frames sync index       : {r.sync_index:6d}")
        print(f"    num samples processed   : {r.samples_processed:6d}")
        print(f"    num_occupied_carriers   : {r.num_occupied_carriers:6d}")
        print(f"    symbols transmitted     : {r.symbols_transmitted:6d}")
        for i, (v, ser) in enumerate(zip(r.valid_symbols, r.symbol_error_rate)):
            print(f"    valid symbols received {i}: {v:6d}")
            print(f"    symbol error rate      {i}: {ser:1.6f}%")
        if r.decode_seconds:
            print(f"    decode run time         : {r.decode_seconds:.4f} s")
            print(f"    samples / second        : {r.samples_per_second:.3e}")


def _bit_errors(a: np.ndarray, b: np.ndarray, bits: int) -> int:
    x = (a.astype(np.uint32) ^ b.astype(np.uint32)) & ((1 << bits) - 1)
    return int(np.unpackbits(x.view(np.uint8)).sum())


def score(
    result: DecodeResult,
    tx_data: np.ndarray,
    cfg: ModemConfig,
    decode_seconds: float = 0.0,
    num_samples: int = 0,
) -> ExperimentReport:
    """Compare decoded symbols with ground truth (main.cc:1403-1411)."""
    result = fetch_tree(result)  # one batched device->host conversion
    rx_data = np.asarray(result.rx_data)
    tx_data = np.asarray(tx_data)
    m_occ = cfg.M_occupied
    n = cfg.pid_max * m_occ
    valid_sym = np.asarray(result.symbol_valid)
    frames = int(valid_sym.sum())

    if cfg.mode == CommMode.SISO:
        streams = [(cfg.siso_rx, cfg.siso_tx)]
    elif cfg.mode == CommMode.RX_DIVERSITY:
        streams = [(cfg.siso_tx, cfg.siso_tx)]  # MRC output lane
    elif cfg.mode == CommMode.ALAMOUTI:
        streams = [(0, 0)]  # single logical stream on lane 0
    else:
        streams = [(s, s) for s in range(cfg.num_streams)]

    from rub_mimo_tpu.ofdm import constellation

    table = constellation.table(cfg.modulation)
    rx_sig = np.asarray(result.rx_sig) if result.rx_sig is not None else None

    valid_counts, sers, bers, evms = [], [], [], []
    for rx_s, tx_s in streams:
        match = rx_data[rx_s, :n] == tx_data[tx_s, :n]
        good = int(match.sum())
        valid_counts.append(good)
        sers.append(float(n - good) / float(n) * 100.0)
        bers.append(
            _bit_errors(rx_data[rx_s, :n], tx_data[tx_s, :n],
                        cfg.modulation.bits_per_symbol)
            / float(n * cfg.modulation.bits_per_symbol)
        )
        if rx_sig is not None:
            # EVM vs the transmitted constellation points (% RMS)
            ideal = table[tx_data[tx_s, :n]]
            err = rx_sig[rx_s, :n] - ideal
            evms.append(float(
                np.sqrt(np.mean(np.abs(err) ** 2)
                        / np.mean(np.abs(ideal) ** 2)) * 100.0
            ))

    ps = np.asarray(result.plateau_start).tolist()
    pe = np.asarray(result.plateau_end).tolist()
    return ExperimentReport(
        synced=bool(result.synced),
        sync_index=int(result.sync_index),
        plateau_start=ps,
        plateau_end=pe,
        plateau_width=[int(e - s + 1) for s, e in zip(ps, pe)],
        num_occupied_carriers=m_occ,
        frames_decoded=frames,
        symbols_transmitted=n * len(streams),
        valid_symbols=valid_counts,
        symbol_error_rate=sers,
        bit_error_rate=bers,
        evm_percent=evms or None,
        cfo_hat=float(result.cfo_hat),
        samples_processed=num_samples,
        decode_seconds=decode_seconds,
        samples_per_second=(
            num_samples * cfg.num_streams / decode_seconds
            if decode_seconds
            else 0.0
        ),
    )
