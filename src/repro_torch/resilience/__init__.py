"""Fault plans, checkpoint layouts and the supervised training loop
(counterpart of ``repro/resilience/``)."""
