"""A2S scripts shared by the port's tests and ``chip_smoke.py``."""

# Polyphonic wavetable voices panmixed into the master bus (saw
# notes, sine bells, noise hats): every voice is wtosc -> panmix, so a
# superblock records oscillator runs (linear and ramp-replayed, noise
# included) and panmix/copy stage rows only.  256 loop iterations of
# 35 ms plus a 1.5 s tail: about 10.5 s of audio.
SLICE_SONG = """
Note(P V=1 Pn=0)
{
	struct { wtosc; panmix }
	w saw; p P; pan Pn
	a V; d 30
	a (V * .4); d 300
	p (P + .5); a 0; d 600
}
Bell(P V=1)
{
	struct { wtosc; panmix }
	w sine; p P
	a V; d 10
	a 0; d 1500
}
Hat(V=1)
{
	struct { wtosc; panmix }
	w noise; p 5
	a V; d 5
	a 0; d 60
}
Song()
{
	!n 0
	256 {
		Note (n * .0833 - 1) .02 (n * .004 - .5)
		Bell (n * .0833) .01
		Hat .05
		+n 1
		d 35
	}
	d 1500
}
"""
