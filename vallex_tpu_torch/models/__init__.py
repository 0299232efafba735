"""VALL-E X model: layers and the forward functions of its two stacks."""
