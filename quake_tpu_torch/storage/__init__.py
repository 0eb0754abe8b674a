"""Partition storage: padded [P, C, D] slabs on the device."""
