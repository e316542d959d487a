"""Fused on-device loopback measurements.

When a measurement's source is the synthetic loopback (TX generator feeding
RX directly — the reference's --sw_loop), the whole chain can live on the
device: `lax.scan` chains K TX->demod blocks per execution with all
streaming state carried through the scan, so nothing touches the host until
the demodulated results come back.  This is the production form of
bench.py's headline configuration.

Supported mode pairs: TONES->DIRECT, TONES->TONES (PFB), TONES->NOISE,
CHIRP->CHIRP (VNA).  Other combinations fall back to the host-driven path
(measure.run_measurement).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import jax

from ..params import AntennaParams, WaveType
from .demodulator import make_demodulator
from .generator import make_generator
from .pipeline import PipelineResult


@dataclasses.dataclass
class FusedLoopback:
    """Compiled K-blocks-per-execution loopback chain."""

    tx: AntennaParams
    rx: AntennaParams
    blocks_per_exec: int = 8

    def __post_init__(self):
        self.demod = make_demodulator(self.rx)
        K = self.blocks_per_exec
        chain = self._try_tones_direct_chain()
        # the chain replaces TX generation entirely — don't materialize an
        # unused generator (a periodic comb's wavetable constant is ~MBs)
        self._chain = chain
        # which chain this loopback actually runs — compared against
        # engine/dispatch.plan_dispatch by tests/test_dispatch_table.py
        self.path = (chain.path_name if chain is not None
                     else "generic_scan")
        self.gen = None if chain is not None else make_generator(
            self.tx, block_len=self.demod.plan.block_len)
        if chain is not None:
            # closed-form chain: synthesis, mix-down and FIR contracted
            # into one matmul per block (ops/fold_chain.py)
            self._init_states = lambda: (chain.init_state(), ())
            rows = self.demod.plan.out_rows
            Cp = self.demod.n_channels

            def _multi_impl(gstate, dstate):
                gstate, y = chain.multi_step(gstate, K)
                return gstate, dstate, y.reshape(K, rows, Cp)

            # donate the chain state: its resident P/ramp factors then
            # alias through instead of being copied on return.  The
            # chain's init_state hands out device copies, so the masters
            # survive for a second acquisition
            multi = jax.jit(_multi_impl, donate_argnums=(0,))
        else:
            gen_step = self.gen.step
            demod_step = self.demod.step
            self._init_states = lambda: (self.gen.init_state(),
                                         self.demod.init_state())

            def body(carry, _):
                gstate, dstate = carry
                gstate, x = gen_step(gstate)
                dstate, y = demod_step(dstate, x)
                return (gstate, dstate), y

            @jax.jit
            def multi(gstate, dstate):
                (gstate, dstate), ys = jax.lax.scan(
                    body, (gstate, dstate), None, length=K)
                return gstate, dstate, ys

        self._multi = multi

    def _try_tones_direct_chain(self):
        """Build the closed-form TONES->DIRECT chain when it applies:
        no burst gating, decimating DIRECT RX.  The shift-fold chain
        (ops/fold_chain.py) contracts synthesis, mix-down and FIR into
        ONE (nb, C_t) x (C_t, C') matmul per block with exact
        single-stage DIRECT arithmetic."""
        tx, rx = self.tx, self.rx
        if not (tx.wave_type and tx.wave_type[0] == WaveType.TONES
                and rx.wave_type and rx.wave_type[0] == WaveType.DIRECT):
            return None
        if tx.burst_on > 0 or int(rx.decim) <= 0 or int(rx.pf_average) < 2:
            return None
        freqs = tuple(int(f) for f in tx.freq)
        if not freqs or not rx.freq:
            return None
        from ..ops.ddc import DirectDDCConfig
        from ..ops.fold_chain import TonesDirectFoldChain
        ampls = tuple(float(a) for a in (tx.ampl or [1.0] * len(freqs)))
        rx_freqs = tuple(int(f) for f in rx.freq)
        dcfg = DirectDDCConfig(
            rate=int(rx.rate), decim=int(rx.decim),
            pf_average=int(rx.pf_average), freqs=rx_freqs,
            phases=(0,) * len(rx_freqs))
        chain = TonesDirectFoldChain(rate=int(tx.rate), tx_freqs=freqs,
                                     tx_ampls=ampls, cfg=dcfg,
                                     block_len=self.demod.plan.block_len)
        return chain if chain.ok else None

    def run(self, sinks=(), usrp_number: int = 0,
            front_end: str = "A") -> PipelineResult:
        """Stream the full acquisition through the fused chain."""
        from .pipeline import run_chunked
        plan = self.demod.plan
        K = self.blocks_per_exec
        n_exec = max(1, -(-plan.n_blocks // K))

        def step(st):
            g, d = st
            g, d, ys = self._multi(g, d)
            return (g, d), ys

        return run_chunked(step, self._init_states, n_exec, plan.n_blocks,
                           plan.block_len, self.demod.n_channels,
                           plan.total_out_rows, sinks,
                           usrp_number=usrp_number, front_end=front_end)


_FUSABLE = {
    (WaveType.TONES, WaveType.DIRECT),
    (WaveType.TONES, WaveType.TONES),
    (WaveType.TONES, WaveType.NOISE),
    (WaveType.CHIRP, WaveType.CHIRP),
}


def can_fuse(tx: Optional[AntennaParams], rx: AntennaParams) -> bool:
    if tx is None or not tx.wave_type or not rx.wave_type:
        return False
    return (tx.wave_type[0], rx.wave_type[0]) in _FUSABLE
