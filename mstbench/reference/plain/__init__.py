"""Frozen copies of the port's plain PyTorch modules, the benchmark's
reference: configuration, DSP ops, FX processors and chains, the batched
normalizer, the FXencoder and MixFXcloner, and the spectral losses.

They import nothing of the port and are not edited to follow it. What
differs from the port: no kernel anywhere (every TCN block runs its plain
channels-first body; the compressor's envelope is ``envelope.py``'s exact
chunked scan), and the normalizer's compression stage sweeps whole signals
lane block by lane block, up to a candidate limit the caller may set.
"""
