"""device_idle_unattributed_share.ai (layer device):
device_idle_unattributed_share, read in the all-intra cell, which
reports no end-to-end fps."""
import harness

read = harness.metric_reader("device_idle_unattributed_share")
