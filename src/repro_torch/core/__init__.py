"""Bit layer, layers and the packed Table 2 network (deployment half)."""
