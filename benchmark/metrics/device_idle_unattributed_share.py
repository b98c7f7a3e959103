"""device_idle_unattributed_share (layer device): the share of the
device's idle time in the traced part, in %, during which the
dispatching thread had no program span open: host time the program's
spans do not account for (the client's own, or a layer without a
span).  Nothing to read without the program's spans."""
import program_spans


def read(run):
    spans = program_spans.traced_host_spans(run)
    if spans is None:
        return None
    return program_spans.unattributed_idle_share(run.traced["device"], spans)
