"""Kernel 4's share of its operation bound at the card's float32 peak (%)."""

from smhbench import march


def read(run):
    return march.roofline(run)
