"""The seven examples of the repository's `examples/`, on the port. Each
runs on the card unless given `--cpu`:

    python -m mpc_ros_tpu_torch.examples.quickstart --cpu
"""
