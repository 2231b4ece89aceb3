"""The benchmark's yardstick: its data files, the traffic generator, the
measured window and its arithmetic, the trace's reduction, the peaks and
least counts, and the comparison that decides `correct`."""
