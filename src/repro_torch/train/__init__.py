"""Training substrate of the port: optimizer, train step, data pipeline,
checkpointing, fault tolerance (port of ``repro/train``)."""
