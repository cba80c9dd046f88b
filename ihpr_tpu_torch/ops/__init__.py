"""Ops: the plain integral soft-argmax and the fused head kernel."""
