"""Telemetry of the port: the counter / gauge / timer registry
(``metrics``), the per-thread timeline, the flight recorder and its
spans, the HBM watermark and the model-FLOPs arithmetic."""
