"""Rendering across ranks on torch.distributed (counterpart of
slr_tpu/parallel/): pixel- and work-sharded path tracing and sharded BPT
(`mesh.py`), scene-sharded path tracing (`scene_shard.py`) and the process
set-up under torchrun (`distributed.py`)."""
