"""Test configuration: run the suite on a virtual 8-device CPU mesh.

Multi-device sharding is exercised without accelerator hardware the
standard way: ``--xla_force_host_platform_device_count`` (SURVEY section 4
"Implication for the rebuild").  Tests run on the CPU unless
``JAX_PLATFORMS`` says otherwise; the ``gpu``-marked tests need
``JAX_PLATFORMS=cuda,cpu`` on a machine with a card.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()
os.environ.setdefault("JAX_PLATFORMS", "cpu")
