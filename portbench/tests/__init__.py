"""CPU tests of the benchmark (the card's are marked ``gpu``)."""
