"""Hand-written Hopper kernels with their plain PyTorch versions.

``LAUNCHES`` counts, per kernel, the wrapper calls that launched the kernel on
the card (calls that took the plain version on a CPU tensor do not count), so
a run can show that its main path went through the kernels. The flash
kernels count by dtype: ``flash_attention`` and ``flash_attention_bwd`` the
bf16 kernels, ``flash_attention_f32`` and ``flash_attention_bwd_f32`` the fp32
ones; a backward call's launches (the Di pass and its kernels) count once.
Each flash kernel's launches at a head dimension that is not one of its
compiled multiples of 64 count under its name with ``_dh<Dh>`` appended
(``_dh32`` at ``num_head_channels: 32``, ``_dh16`` at 16), and not under its
own (``blocked_attention.launch_counter``; the keys of other head dimensions
appear at their first launch); above head dimension 1024 the band route's
kernels count as ``flash_band``, ``flash_band_bwd``, ``flash_band_f32`` and
``flash_band_bwd_f32`` (``blocked_attention.launch_counter``);
GroupNorm launches with FiLM (``use_scale_shift_norm``) count under
``gn_silu_film``, the others under ``gn_silu``.
``nearest_code`` counts the width-3 kernel with the codebook slice resident,
``nearest_code_stream`` the kernel that streams a packed codebook of any
width and size (its packing launch and search count once).

``PLAIN_CALLS`` counts the passes that run plain PyTorch on the card where a
kernel's gradient is needed but the TPU side had no kernel either (the
GroupNorm backward, a jnp function in the JAX package); they are not kernel
launches and stay out of ``LAUNCHES``.
"""

LAUNCHES = {"gn_silu": 0, "flash_attention": 0, "flash_attention_bwd": 0, "nearest_code": 0,
            "flash_attention_f32": 0, "flash_attention_bwd_f32": 0, "nearest_code_stream": 0,
            "flash_attention_dh32": 0, "flash_attention_bwd_dh32": 0,
            "flash_attention_f32_dh32": 0, "flash_attention_bwd_f32_dh32": 0,
            "gn_silu_film": 0, "flash_attention_dh16": 0, "flash_attention_bwd_dh16": 0,
            "flash_attention_f32_dh16": 0, "flash_attention_bwd_f32_dh16": 0,
            "flash_band": 0, "flash_band_bwd": 0, "flash_band_f32": 0, "flash_band_bwd_f32": 0}
PLAIN_CALLS = {"gn_silu_bwd": 0}


def reset_launch_counts() -> None:
    for counts in (LAUNCHES, PLAIN_CALLS):
        for name in counts:
            counts[name] = 0
