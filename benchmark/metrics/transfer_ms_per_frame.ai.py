"""transfer_ms_per_frame.ai (layer api): transfer_ms_per_frame, read
in the all-intra cell, which reports no end-to-end fps."""
import harness

read = harness.metric_reader("transfer_ms_per_frame")
