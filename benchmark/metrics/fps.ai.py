"""fps.ai (layer models.intra_frame): fps, read in the all-intra cell,
where the window is one or two chunks of the wavefront and the host's
speed from run to run spreads it too widely to bound end to end."""
import harness

read = harness.metric_reader("fps")
