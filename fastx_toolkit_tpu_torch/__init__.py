"""fastx_toolkit_tpu_torch — the PyTorch/CUDA port of fastx_toolkit_tpu.

The JAX package ``fastx_toolkit_tpu`` is the reference; this package runs
the same chains on an NVIDIA GPU (Hopper, ``sm_90a``) through PyTorch and
hand-written CUDA kernels, and on the CPU through each kernel's plain
PyTorch version.  Module names mirror the reference's so that each
counterpart is easy to find:

* ``engine/pipeline.py`` — ``PipelineConfig`` and the packed decisions
  body (popcount filter, bit-trick trimmer, masker plane, K1, K2);
* ``kernels/align.py`` — the exact x10-integer adapter DP in plain torch;
* ``kernels/align_cuda.py`` + ``csrc/align_packed12.cu`` — K1, the packed
  adapter DP;
* ``kernels/counts_cuda.py`` + ``csrc/packed_counts.cu`` — K2, the packed
  per-read base counts;
* ``engine/lines.py`` — the streaming raw-line engine;
* ``cli/tools/fastx_pipeline.py`` — the fused-chain CLI
  (``python -m fastx_toolkit_tpu_torch.cli.tools.fastx_pipeline``).

The package imports ``torch`` and never ``jax``; it reuses the reference's
framework-free host codec (``fastx_toolkit_tpu.core``).  Every library
entry point takes an explicit ``device``; the CLI resolves it once from
``FASTX_TORCH_DEVICE`` (see :mod:`.device`).
"""

__version__ = "0.1.0"
