"""What drives the program's entry points, one module per traffic op; a traffic
mix's file names its op and holds its parameters."""
