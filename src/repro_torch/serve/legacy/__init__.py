"""LM serving scaffolding (port of ``repro/serve/legacy``): ``ServeEngine``
over ``repro_torch.models`` plus the prefill/decode steps.  It is unrelated
to the graph simulation."""
