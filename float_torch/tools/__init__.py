"""The port's checkpoint and parity tools (twins of the repository's
``tools/`` scripts that wrap ``float_tpu``), each run as
``python -m float_torch.tools.<name>``:

- ``parity_check``    the port stage by stage against activations recorded
                      from ``float_tpu``
- ``readiness_check`` every storage layout of a checkpoint loads, then
                      parity: prints READY
- ``extract_parts``   component files cut from a unified FLOAT.safetensors
- ``save_combined``   a unified FLOAT.safetensors from component files
- ``check_versions``  ``pyproject.toml`` against ``float_torch.__version__``
"""
