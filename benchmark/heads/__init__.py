"""Program adapters: one module per `head` a configuration names, which
builds the port's matcher and captures what the timed path produced."""
