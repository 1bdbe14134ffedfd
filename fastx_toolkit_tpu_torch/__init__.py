"""fastx_toolkit_tpu_torch — the PyTorch/CUDA port of fastx_toolkit_tpu.

The JAX package ``fastx_toolkit_tpu`` is the reference; this package runs
the same chains on an NVIDIA GPU (Hopper, ``sm_90a``) through PyTorch and
hand-written CUDA kernels, and on the CPU through each kernel's plain
PyTorch version.  Module names mirror the reference's so that each
counterpart is easy to find:

* ``core/`` — the port's own host codec (framing, validation, packing,
  rendering, the float32 clipper DP; ``native/fastx_codec.cpp`` built
  with g++ at first import);
* ``engine/pipeline.py`` — ``PipelineConfig`` and the decisions bodies
  (the fully-packed body with K1/K3 and K2, the unpacked ones with K4);
* ``engine/lines.py`` — the streaming raw-line engine;
* ``kernels/align.py`` — the exact x10-integer adapter DP in plain torch;
* ``kernels/align_cuda.py`` + ``csrc/align_packed.cu`` — K1 and K3, the
  packed adapter DP (one lane-group kernel at both kernels' shapes);
* ``kernels/align_unpacked_cuda.py`` + ``csrc/align_unpacked.cu`` — K4,
  the unpacked adapter DP (a lane-group kernel, and one thread a read
  beyond its adapter bound);
* ``kernels/counts_cuda.py`` + ``csrc/packed_counts.cu`` — K2, the packed
  per-read base counts;
* ``ops/transforms.py``, ``ops/clipper.py`` — the per-read tools;
* ``ops/collapse.py`` — the collapser's sort and segment sums on the
  device, and its host-side order and id columns;
* ``cli/tools/*.py`` — the CLIs (``python -m
  fastx_toolkit_tpu_torch.cli.tools.<tool>``), and ``cli/main.py`` the
  ``fastx-torch`` dispatcher over them;
* ``parallel/multihost.py`` — byte-range sharding of every CLI's input
  and the host merges over a gloo process group; ``cli/pod.py`` the
  ``fastx_pod_torch`` launcher; ``parallel/mesh.py`` — the sharded
  stats, pipeline, collapse and barcode tallies over a ``DeviceMesh``;
* ``synth.py`` — seeded lanes; ``profile_paths.py`` — the card's busy
  share per path, and the engine policy's kinds timed.

The package imports ``torch`` and never ``jax`` or anything of the JAX
package.  Every library entry point takes an explicit ``device``; the
CLIs resolve it once from ``FASTX_TORCH_DEVICE`` (see :mod:`.device`).
"""

__version__ = "0.2.0"
