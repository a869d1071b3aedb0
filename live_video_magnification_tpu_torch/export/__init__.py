"""Clip processing with carried state and checkpoint/resume, and the
record-and-export worker (``exporter.Exporter``, ``recording``, ``sources``)."""
