"""The mLSTM's matrix-memory recurrence over a sequence: the mlstm_scan
kernel."""
