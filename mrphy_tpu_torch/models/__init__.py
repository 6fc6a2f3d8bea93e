r"""User-facing object model: Pulse, SpinArray, SpinCube, SpinBolus,
Examples."""
