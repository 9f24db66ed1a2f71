"""Training of the matcher heads (gim_loftr so far): losses and the step."""
