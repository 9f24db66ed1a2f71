"""Traffic kinds: one module per `kind` a traffic file names, which
drives the program for the window and says what a call completed."""
