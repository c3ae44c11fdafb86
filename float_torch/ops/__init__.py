from .activations import fused_leaky_relu, leaky_relu
from .equalized import equal_conv2d, equal_linear
from .interp import linear_interpolate_time
from .modulated import modulated_conv2d
from .ode import ODE_TABLEAUS, odeint_fixed
from .upfirdn import downsample2x, make_blur_kernel, upfirdn2d, upsample2x
from .warp import identity_grid, warp_shared, warp_shared_ref

__all__ = [
    "fused_leaky_relu", "leaky_relu", "equal_conv2d", "equal_linear",
    "linear_interpolate_time", "modulated_conv2d", "ODE_TABLEAUS",
    "odeint_fixed", "downsample2x", "make_blur_kernel", "upfirdn2d",
    "upsample2x", "identity_grid", "warp_shared", "warp_shared_ref",
]
