"""Serving in the port: the LM's prefill and greedy decode
(`serve_step`), and the co-search service (`cosearch_service`) behind
its HTTP front-end (`server`)."""
