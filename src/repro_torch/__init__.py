"""repro_torch: the AnalogNets / AON-CiM serving path in PyTorch for Hopper.

A second package beside ``repro`` (the JAX reference). Its module layout
mirrors ``repro``'s so each port module sits at its counterpart's path.
It imports ``torch`` and never ``jax``, and nothing of ``repro``: what it
needs of the reference lives here as its own copy.

Idiom: plain functions over tensors and dicts of tensors; every entry point
takes an explicit ``device`` (default ``"cuda"``, which raises on a host
without a card -- pass ``device="cpu"`` for the plain versions); noise comes
from threefry keys through the RNG bridge ``repro_torch.prng``, bit for bit
``jax.random``'s draws; execution is eager.

Ported so far: program-once, execute-many serving of a dense LM on one
programmed chip (``core.engine.compile_program`` or
``checkpoint.store.load_program`` -> ``serving.ServingEngine``, CLI
``launch.serve``), with every programmed MVM on a CUDA tensor launching
the hand-written Hopper kernel ``kernels.analog_mvm``
(``csrc/analog_mvm.cu``), or, with ``fused_decode``, every decode step
one launch of ``kernels.decode_fused`` (``csrc/decode_fused.cu``); the
per-layer decode's norms, RoPE, attention and gate run B2's row code
(``kernels.decode_rows``); the chip ages, refreshes and is saved as the
reference's does (``core.engine.age_program``, ``serving.DriftPolicy``,
``checkpoint.store.save_program``).
"""

__version__ = "0.1.0"
