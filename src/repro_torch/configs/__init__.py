"""Model configurations of the port: the paper's vision configs
(``spike_iand_former``) and the text configs the spiking LM runs at
(``llama3_2_1b``, registered in ``repro_torch.models.lm``)."""
