"""Telemetry: the standalone instruments the serving engine's
``stats()`` reads (``core``)."""
