"""Telemetry of the port: the counter / gauge / timer registry."""
