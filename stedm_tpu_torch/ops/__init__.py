"""Hand-written Hopper kernels with their plain PyTorch versions.

``LAUNCHES`` counts, per kernel, the wrapper calls that launched the kernel on
the card (calls that took the plain version on a CPU tensor do not count), so
a run can show that its main path went through the kernels.

``PLAIN_CALLS`` counts the passes that run plain PyTorch on the card where a
kernel's gradient is needed but the TPU side had no kernel either (the
GroupNorm backward, a jnp function in the JAX package); they are not kernel
launches and stay out of ``LAUNCHES``.
"""

LAUNCHES = {"gn_silu": 0, "flash_attention": 0, "flash_attention_bwd_dkv": 0,
            "flash_attention_bwd_dq": 0, "nearest_code": 0}
PLAIN_CALLS = {"gn_silu_bwd": 0}


def reset_launch_counts() -> None:
    for counts in (LAUNCHES, PLAIN_CALLS):
        for name in counts:
            counts[name] = 0
