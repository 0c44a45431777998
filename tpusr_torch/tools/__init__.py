"""Offline tools: the serving gate and the tools that merge and re-derive
its reports."""
