"""A faithful per-sample CPU port of the reference receiver, for testing.

This module re-implements framesync's serial state machine exactly as the
C++ does it — per-sample loops, liquid-style streaming filter state, the
windowcf sliding buffer, per-code argmax, identity-biased Ghat — so the
block pipeline can be validated against true reference SEMANTICS
(SURVEY §6: "bit-exactness vs. a faithful CPU port of the chain").

Only used by tests on tiny configs (it is deliberately slow).
Citations are to /root/reference/mimo/framing.cc.
"""

from __future__ import annotations

import numpy as np

from rub_mimo_tpu.config import ModemConfig
from rub_mimo_tpu.ofdm import preamble, sctype


class SerialFramesync:
    """Per-sample replication of rx_beamforming::framesync."""

    def __init__(self, cfg: ModemConfig):
        self.cfg = cfg
        S = cfg.num_streams
        M = cfg.M
        self.M2 = M // 2
        t = preamble.tables(cfg)
        self.S0 = t.S0.astype(np.complex64)
        self.S1 = t.S1.astype(np.complex64)  # [tx, code, M]
        self.p = cfg.subcarrier_allocation()
        self.occupied = self.p != sctype.SCTYPE_NULL

        # liquid filter state (framing.cc:381-388): zero-initialized
        self.delay = np.zeros((S, self.M2), np.complex64)
        self.corr_state = np.zeros((S, self.M2), np.complex64)
        self.norm_state = np.zeros((S, M), np.float32)

        self.in_plateau = np.zeros(S, bool)
        self.plateau_start = np.zeros(S, np.int64)
        self.plateau_end = np.zeros(S, np.int64)
        self.sync_index = 0
        self.num_samples_processed = 0
        self.state = "SEEK_PLATEAU"

        self.window_len = cfg.window_len
        # windowcf backing store, zero-initialized (framing.cc:387)
        self.window = np.zeros((S, self.window_len), np.complex64)
        self.metric_log = [[] for _ in range(S)]

        self.G = None
        self.W = None
        self.normalize_gain = None
        self.ac_index = None
        self.decoded = []  # list of [S, M_occupied] equalized symbols

    # ------------------------------------------------------------ sync
    def _push_window(self, x):
        self.window = np.roll(self.window, -1, axis=1)
        self.window[:, -1] = x

    def _sc_metric_one(self, s, xs):
        # framing.cc:626-637
        xd = self.delay[s, 0]
        self.delay[s] = np.roll(self.delay[s], -1)
        self.delay[s, -1] = xs
        self.corr_state[s] = np.roll(self.corr_state[s], -1)
        self.corr_state[s, -1] = np.conj(xd) * xs
        c = -np.sum(self.corr_state[s])
        self.norm_state[s] = np.roll(self.norm_state[s], -1)
        self.norm_state[s, -1] = np.float32(abs(xs) ** 2)
        e = np.float32(0.5) * np.sum(self.norm_state[s])
        with np.errstate(invalid="ignore", divide="ignore"):
            return np.float32((c.real**2 + c.imag**2) / (e * e))

    def _seek_plateau(self, x):
        cfg = self.cfg
        proceed = True
        for s in range(cfg.num_streams):
            y = self._sc_metric_one(s, x[s])
            self.metric_log[s].append(y)
            if y > cfg.plateau_threshold:
                if self.in_plateau[s]:
                    self.plateau_end[s] = self.num_samples_processed
                else:
                    self.in_plateau[s] = True
                    self.plateau_start[s] = self.num_samples_processed
                    self.plateau_end[s] = self.num_samples_processed
            else:
                self.in_plateau[s] = False
            proceed = proceed and (
                self.plateau_end[s] - self.plateau_start[s] > cfg.cp_len
            ) and self.in_plateau[s]
        if proceed:
            # framing.cc:617-622 (integer division)
            self.sync_index = int(
                self.plateau_start.sum() // cfg.num_streams
            )
            self.state = "SAVE_ACCESS_CODES"

    # ------------------------------------------------ estimation/decode
    def _estimate_channel(self):
        cfg = self.cfg
        S, M = cfg.num_streams, cfg.M
        sym = cfg.symbol_len
        max_ac = S * cfg.num_access_codes
        buf = self.window
        s1_t = preamble.tables(cfg).s1_unnormalized  # ifftw(S1) templates

        # offset search (framing.cc:702-744, USE_NEW_CHANNEL_EST)
        corr_idx = np.zeros((S, max_ac), np.int64)
        max_corr = np.zeros((S, max_ac), np.float32)
        for i in range(sym):
            for rxs in range(S):
                for code in range(cfg.num_access_codes):
                    for txs in range(S):
                        ac = code * S + txs
                        samp = i + sym * (ac + 1)
                        X = np.fft.fft(buf[rxs, samp : samp + M])
                        xyz = np.vdot(self.S1[txs, code], X)  # sum X*conj(S1)
                        v = np.float32(
                            (xyz.real**2 + xyz.imag**2) / float(M * M)
                        )
                        if v > max_corr[rxs, ac]:
                            max_corr[rxs, ac] = v
                            corr_idx[rxs, ac] = samp
        self.ac_index = corr_idx

        # LS with identity init (framing.cc:302-319, 801-824)
        G = np.zeros((M, S, S), np.complex64)
        if cfg.bit_exact:
            for sc in range(M):
                if self.occupied[sc]:
                    G[sc] = np.eye(S)
        for code in range(cfg.num_access_codes):
            for rxs in range(S):
                for txs in range(S):
                    ac = code * S + txs
                    off = corr_idx[rxs, ac]
                    X = np.fft.fft(buf[rxs, off : off + M])
                    mask = self.occupied
                    G[mask, rxs, txs] += (
                        X[mask] / self.S1[txs, code][mask]
                    ).astype(np.complex64)
        dft_norm = np.float32(1.0 / np.sqrt(self.occupied.sum()))
        G *= dft_norm / np.float32(cfg.num_access_codes)
        self.G = G

        # invert (framing.cc:1344-1367)
        W = np.zeros_like(G)
        gain = np.ones(int(self.occupied.sum()), np.float32)
        j = 0
        for sc in range(M):
            if not self.occupied[sc]:
                continue
            g = G[sc]
            det = g[0, 0] * g[1, 1] - g[0, 1] * g[1, 0]
            det_inv = np.conj(det)
            W[sc, 0, 0] = det_inv * g[1, 1]
            W[sc, 1, 1] = det_inv * g[0, 0]
            W[sc, 1, 0] = -det_inv * g[1, 0]
            W[sc, 0, 1] = -det_inv * g[0, 1]
            gain[j] = np.float32(1.0 / (det.real**2 + det.imag**2))
            j += 1
        self.W = W
        self.normalize_gain = gain

        # replay the rest of the buffer (framing.cc:853-868); per-sample
        # dispatch to the MIMO (framing.cc:535-589) or SISO
        # (framing.cc:508-533) decode
        start = corr_idx[1, max_ac - 1] + M
        sym_buf = []
        occ = np.nonzero(self.occupied)[0]
        siso = cfg.mode.value == "siso"
        for i in range(start, self.window_len):
            sym_buf.append(buf[:, i])
            if len(sym_buf) == sym:
                block = np.stack(sym_buf, axis=1)  # [S, sym]
                sym_buf = []
                Xs = np.fft.fft(block[:, cfg.cp_len :], axis=1) * dft_norm
                out = np.zeros((S, len(occ)), np.complex64)
                if siso:
                    rxs, txs = cfg.siso_rx, cfg.siso_tx
                    for jj, sc in enumerate(occ):
                        out[rxs, jj] = Xs[rxs, sc] / G[sc, rxs, txs]
                else:
                    for jj, sc in enumerate(occ):
                        out[0, jj] = (
                            W[sc, 0, 0] * Xs[0, sc] + W[sc, 0, 1] * Xs[1, sc]
                        )
                        out[1, jj] = (
                            W[sc, 1, 0] * Xs[0, sc] + W[sc, 1, 1] * Xs[1, sc]
                        )
                    out *= gain[None, :]
                self.decoded.append(out)

    def execute(self, capture: np.ndarray) -> None:
        """Feed the whole capture one sample at a time (framing.cc:471-506)."""
        T = capture.shape[1]
        for t in range(T):
            x = capture[:, t]
            if self.state == "SEEK_PLATEAU":
                self._push_window(x)  # framing.cc:596
                self._seek_plateau(x)
            elif self.state == "SAVE_ACCESS_CODES":
                # framing.cc:639-651
                if (
                    self.num_samples_processed - self.sync_index
                    < self.cfg.tx_sig_samples
                    + self.cfg.access_code_buffer_len
                    - self.cfg.symbol_len
                ):
                    self._push_window(x)
                else:
                    self._estimate_channel()
                    self.state = "MIMO_DONE"
                    return
            else:
                return
            self.num_samples_processed += 1
