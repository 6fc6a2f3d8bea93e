r"""Bloch engines and B-effective assembly (counterpart of
:mod:`mrphy_tpu.ops`)."""
