"""Serving runtime: the continuous-batching ``server.DecodeServer`` and its
``scheduler``."""
