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

# Effects: saw leads through filter12 and dcblock, fm2 bells, both into
# a stereo feedback delay, the whole song through a stereo limiter on
# the master bus.  140 loop steps of 70 ms plus a 1.5 s tail: about
# 11 s of audio.  A 2752x64-frame superblock records one dense stereo
# fbdelay item (fb/ld/rd 300/200/250 ms), the master limiter (one
# instance), and filter12, dcblock and fm items of about 60 instances.
# The argument T (default 0) transposes the leads and bells.
EFFECTS_SONG = """
Lead(P V=1)
{
	struct { wtosc; filter12; dcblock db; panmix }
	lp .5; bp .4; hp .2
	w saw; p P; a (V * .3)
	cutoff 3; q 1.5
	db.cutoff 2n
	d 30
	cutoff (P + 2); q .7; d 200
	a 0; d 150
}
Bell(P V=1)
{
	struct { fm2; panmix }
	p P; a V; p1 (P + 1); a1 .5; fb .2
	d 10
	a 0; d 350
}
Echo(T=0)
{
	struct { inline 0 2; fbdelay 2 2; panmix 2 > }
	fbdelay 300; ldelay 200; rdelay 250
	drygain .7; fbgain .3; lgain .3; rgain .3
	!n 0
	140 {
		Lead (T + n * .0833 - 1) .3
		Bell (T + n * .0833 + 1) .1
		+n 1
		d 70
	}
	d 1500
}
Song(T=0)
{
	struct { inline 0 2; panmix PM 2 2; limiter L 2 > }
	L.release 64; L.threshold 4
	1:Echo T
	d 11000
}
"""

# A mono fbdelay voice that starts 100 ms into the song: the first
# superblock covers the delay only partly, so the instance takes the
# fbdelay's legacy form (a 2^20 ring) for the whole song.  About 1.4 s.
LATE_FBDELAY_SONG = """
Song(V=1)
{
	struct { wtosc; fbdelay; panmix }
	drygain .5; fbgain .4; lgain .4; rgain .4
	w saw; a (V * .3); p 0n
	d 1100
	a 0
	d 100
}

export SongMain(V=1)
{
	struct { inline; panmix }
	d 100
	1:Song V
	d 1300
}
"""

# the songs by name, with the program each starts
SONGS = {"slice": (SLICE_SONG, "Song"), "effects": (EFFECTS_SONG, "Song"),
         "late_fbdelay": (LATE_FBDELAY_SONG, "SongMain")}
