"""Hand-written CUDA kernels of the main path, each beside its plain PyTorch
version in the same module.

A wrapper runs the plain version for a tensor on the CPU, and for a CUDA
tensor checks it and launches its kernel or raises. ``LAUNCHES`` counts the
kernel launches per wrapper, so a run can show that it went through them.
"""

LAUNCHES = {"diffusion_block": 0, "diffusion_step": 0, "warp2d": 0, "compose": 0,
            "logger_norms": 0, "demons_onepass": 0, "demons_correspondence": 0,
            "compose_smooth": 0, "elastic_block": 0, "fluid_iter": 0, "fluid_metrics": 0,
            "fluid_sweep_max": 0, "fluid_euler": 0, "diffusion_block_strip": 0,
            "elastic_block_strip": 0, "fluid_iter_strip": 0, "warp2d_strip": 0,
            "compose_strip": 0, "demons_onepass_strip": 0, "demons_correspondence_strip": 0,
            "compose_smooth_strip": 0, "diffusion_block_batch": 0, "diffusion_step_batch": 0,
            "warp2d_batch": 0, "compose_batch": 0, "logger_norms_batch": 0,
            "upsample_motion": 0, "derive": 0, "downsample": 0, "fluid_iter_batch": 0,
            "fluid_metrics_batch": 0, "derive_batch": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0
