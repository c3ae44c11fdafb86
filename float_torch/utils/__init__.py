"""Host-side utilities of the port (twins of ``float_tpu.utils``): logging
setup, parameter counting, analytic FLOP accounting and stage timing."""
