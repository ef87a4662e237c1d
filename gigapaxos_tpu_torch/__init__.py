"""gigapaxos_tpu_torch — the PyTorch/CUDA port of gigapaxos_tpu.

A group-scalable replicated state machine framework: millions of
independent Paxos consensus groups per node, behind a
``Replicable{execute, checkpoint, restore}`` app SPI.  The acceptor and
coordinator state of *all* groups lives as device-resident ``[G]`` /
``[G, W]`` int32 tensors, and prepare/accept/decide for every group
advance together in one step — on an NVIDIA H100 one hand-written CUDA
kernel launch (``csrc/gp_step.cu``), on the CPU the plain PyTorch
transcription of the JAX package's engine.  Inter-replica Paxos traffic
is one packed int32 state blob per replica per step.

The JAX package ``gigapaxos_tpu`` beside this one is the reference; this
package imports nothing of it and nothing of JAX.  Entry points run on
the card unless the caller passes ``device="cpu"``.

Layout (the same relative paths as the reference):
  utils/       config flags, delay profiler
  obs/         structured logging, per-request tracing, metrics,
               device-plane sentinel / heat / profiler
  interfaces/  Replicable app SPI, Request types
  packets/     wire packets
  ops/         the consensus engine (plain PyTorch + the CUDA kernel
               wrapper) and group lifecycle ops
  csrc/        the hand-written CUDA sources
  parallel/    the make_step factory (stacked / packed_host faces)
  storage/     journal + checkpoint durability
  recovery/    segmented replay, lazy hydration
  net/         host transport and codecs
  native/      C++ journal and wire codec (ctypes)
  models/      example Replicable apps
  clients/     async client
  testing/     in-process simulator and manager cluster
"""

__version__ = "0.1.0"
