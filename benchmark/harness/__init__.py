"""What every cell shares: finding its files, traffic, seeded weights,
the window, spans and the trace, the peaks, the check and the fence."""
