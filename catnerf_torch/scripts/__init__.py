"""The port's entry-point scripts: registration alone
(`run_registration`) and the train-mesh-evaluate suite over the shipped
configs (`run_suite`)."""
