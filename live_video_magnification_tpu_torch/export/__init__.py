"""Clip processing with carried state and checkpoint/resume."""
