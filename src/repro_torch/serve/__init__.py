"""Serving in the port.

:mod:`repro_torch.serve.legacy` holds the LM serving scaffolding: a batched
KV-cache ``ServeEngine`` over :mod:`repro_torch.models`.  The sweep server
of the reference's ``repro.serve`` is not ported yet.
"""
