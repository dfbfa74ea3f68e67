"""Serving steps of the port's LM: prefill and greedy decode."""
