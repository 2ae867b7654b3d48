"""Transports of the port's runtime: wire frames, control plane, service."""
