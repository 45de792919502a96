"""Serving observability of the port: the metrics registry
(:mod:`.metrics`), request tracing (:mod:`.tracing`) and the per-tenant
SLO ledger (:mod:`.slo`), own copies of the JAX package's."""
