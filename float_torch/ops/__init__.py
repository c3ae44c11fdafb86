from .activations import fused_leaky_relu, leaky_relu
from .equalized import equal_conv2d, equal_linear
from .interp import linear_interpolate_time, nearest_interpolate_time
from .modulated import modulated_conv2d
from .ode import ODE_TABLEAUS, odeint_fixed
from .upfirdn import (blur, downsample2x, make_blur_kernel, upfirdn2d,
                      upsample2x)
from .warp import (DISPATCH, PLAIN, Warps, grid_sample_bilinear,
                   grid_sample_bilinear_ref, identity_grid, warp_per_frame,
                   warp_per_frame_ref, warp_rgb, warp_rgb_ref, warp_shared,
                   warp_shared_ref)
from .yuv420 import i420_to_rgb_u8, rgb01_to_i420

__all__ = [
    "fused_leaky_relu", "leaky_relu", "equal_conv2d", "equal_linear",
    "linear_interpolate_time", "nearest_interpolate_time",
    "modulated_conv2d", "ODE_TABLEAUS",
    "odeint_fixed", "blur", "downsample2x", "make_blur_kernel", "upfirdn2d",
    "upsample2x", "grid_sample_bilinear", "grid_sample_bilinear_ref",
    "identity_grid", "warp_shared", "warp_shared_ref",
    "warp_per_frame", "warp_per_frame_ref", "warp_rgb", "warp_rgb_ref",
    "Warps", "DISPATCH", "PLAIN", "rgb01_to_i420", "i420_to_rgb_u8",
]
