# Execution base: device mesh + precision policy (``tpu_cfg`` keeps its
# historical name because user configs set it).
# Replaces the reference's HuggingFace-Accelerate base
# (configs/__base__/accelerate.py) with JAX/GSPMD-native settings.
cfg = dict(
    tpu_cfg=dict(
        # mesh axis sizes; -1 on `data` means "all remaining devices".
        mesh=dict(data=-1, model=1),
        # compute dtype for the backbone / decoder forward passes; unset,
        # it follows the platform (bf16 on the GPU, f32 on the CPU).
        compute_dtype="bfloat16",
        # parameters and optimizer state dtype.
        param_dtype="float32",
        # donate input buffers to jitted steps where safe.
        donate_state=True,
    ),
)
