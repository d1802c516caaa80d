"""Command-line measurement tools of the port, run as
``python -m nerf_tpu_torch.tools.<name>``: ``batch_scaling`` (the training
step's rays/s and peak memory across ray batches) and
``bench_ref_kernels`` (the Ref-NeRF kernels timed alone, and the
directional kernels' stage-by-stage dissection)."""
