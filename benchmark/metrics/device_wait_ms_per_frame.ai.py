"""device_wait_ms_per_frame.ai (layer api): device_wait_ms_per_frame, read
in the all-intra cell, which reports no end-to-end fps."""
import harness

read = harness.metric_reader("device_wait_ms_per_frame")
