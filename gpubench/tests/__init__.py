"""CPU tests of the benchmark's harness (the card's tests carry ``gpu``)."""
