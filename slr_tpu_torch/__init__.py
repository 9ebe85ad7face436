"""slr_tpu_torch — the spectral path tracer on PyTorch and CUDA.

A port of the `slr_tpu` package to PyTorch, with the traversal kernels
written by hand in CUDA C++ for Hopper (`csrc/`). The layout mirrors
`slr_tpu` module for module and keeps the names of the functions ported, so
each function's counterpart is found under the same path.

Entry points (`python -m slr_tpu_torch <scene.txt>`, `scene.api.load_scene`,
`scene.presets.cornell_box_spheres`, `scene.presets.grass_field`,
`render.wavefront.render_wavefront`, `render.film.develop`) run on the CUDA
device unless the caller passes `device="cpu"` (`--cpu`); without a CUDA
device they raise instead of falling back.
"""

__version__ = "0.1.0"
