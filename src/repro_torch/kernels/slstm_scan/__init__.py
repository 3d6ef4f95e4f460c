"""The sLSTM's scalar-memory recurrence over a sequence: the slstm_scan
kernel."""
