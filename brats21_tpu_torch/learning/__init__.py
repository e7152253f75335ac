"""Serial single-device evaluation engine."""
